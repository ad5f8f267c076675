"""Command-line entry points: the port of ``train/cli.py``.

    python -m asr_dfcnn_transformer_torch.train.cli am       --workdir W [...]
    python -m asr_dfcnn_transformer_torch.train.cli lm       --workdir W [...]
    python -m asr_dfcnn_transformer_torch.train.cli atten    --workdir W [...]
    python -m asr_dfcnn_transformer_torch.train.cli e2e      --workdir W [...]
    python -m asr_dfcnn_transformer_torch.train.cli joint    --workdir W [...]
    python -m asr_dfcnn_transformer_torch.train.cli eval     --workdir W [...]
    python -m asr_dfcnn_transformer_torch.train.cli eval-lm  --workdir W [...]
    python -m asr_dfcnn_transformer_torch.train.cli eval-e2e --workdir W [...]
    python -m asr_dfcnn_transformer_torch.train.cli eval-atten --workdir W [...]
    python -m asr_dfcnn_transformer_torch.train.cli infer    --workdir W --wav f.wav [--streaming]
    python -m asr_dfcnn_transformer_torch.train.cli export   --workdir W --out P [--what am|lm|bigru] [--format tf1|hdf5]
    python -m asr_dfcnn_transformer_torch.train.cli export-serving --workdir W --out A.zip [--what pipeline|e2e]
    python -m asr_dfcnn_transformer_torch.train.cli infer-artifact --artifact A.zip --wav f.wav
    python -m asr_dfcnn_transformer_torch.train.cli serve    (--workdir W | --artifact A.zip) [--streams N]

The JAX CLI's commands, flags and defaults, on the port's models, trainers
and kernels; the accuracy lines are printed in the JAX CLI's words, so a
script reads either package's output. Everything runs on the card (CUDA;
the command raises without it) unless ``--platform cpu``. The full-width
models are built through ``train/factory.py`` from the resolved config, so
``--config`` reaches their kernel selectors (``fused_ffn="pallas"``); with
the default config they are the JAX CLI's models field for field, and
``--small`` builds the JAX CLI's small models. ``--synthetic N`` writes the
JAX CLI's tone corpus under ``<workdir>/synthetic``. ``atten`` and
``joint`` build the JAX CLI's CTC-attention and joint models as it does,
outside the config tree; ``--tensorboard`` on the five training commands
writes TensorBoard event files under ``<workdir>/tb/<name>`` (e2e: with
attention images).

A serving artifact (``export-serving``) is served on the platforms that
``--serve-platforms`` names (``cpu``, ``cuda`` or ``cpu,cuda``; default:
the exporting device's), whatever the exporting device: ``--platform cpu
--serve-platforms cpu,cuda`` exports one for the card on a CPU host.
``infer-artifact`` and ``serve --artifact`` load it on ``--platform``, as
the other commands run there (default cuda), and refuse a device that it
was not exported for.

``--distributed`` joins a process group of one process per device before
anything runs, from ``torchrun``'s environment or from
``--coordinator-address`` / ``--num-processes`` / ``--process-id``; each
process takes ``cuda:{LOCAL_RANK}`` (``--platform cpu``: the CPU, over
gloo), and the training commands' trainers lay their data-parallel mesh
over the group (``parallel/mesh.py``); rank 0 writes the synthetic corpus,
the resolved config and every checkpoint:

    torchrun --nproc_per_node N -m asr_dfcnn_transformer_torch.train.cli am --workdir W --distributed
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os
import sys

import torch

AM_NAMES = ["dfcnn", "se_dfcnn", "se_dfcnn_pre", "se_dfcnn_fast",
            "keras_dfcnn", "bigru"]
TRAIN_COMMANDS = ("am", "lm", "atten", "e2e", "joint")


def _build_parser():
    p = argparse.ArgumentParser(prog="asr-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp, workdir_required=True):
        sp.add_argument("--workdir", required=workdir_required, default=None)
        sp.add_argument("--data-dir", default=None)
        sp.add_argument("--speech-root", default=None)
        sp.add_argument("--noise-root", default="")
        sp.add_argument("--corpora",
                        default="thchs,aishell,aidatatang,stcmd,prime")
        sp.add_argument("--synthetic", type=int, default=0,
                        help="generate N synthetic utterances instead of "
                             "reading real manifests")
        sp.add_argument("--batch-size", type=int, default=None)
        sp.add_argument("--epochs", type=int, default=None)
        sp.add_argument("--lr", type=float, default=None)
        sp.add_argument("--seed", type=int, default=0)
        sp.add_argument("--small", action="store_true",
                        help="tiny f32 model dims (tests / smoke)")
        sp.add_argument("--platform", default=None,
                        help="torch device to run on (default: cuda, "
                             "which must exist; 'cpu' runs on the CPU)")
        sp.add_argument("--distributed", action="store_true",
                        help="multi-process run: join a torch.distributed "
                             "process group (NCCL on cuda, gloo on the "
                             "CPU) before any work, one process per "
                             "device. Under torchrun the rank, world size "
                             "and rendezvous are auto-detected; elsewhere "
                             "pass the three flags below. The (data, "
                             "model) mesh then spans every process.")
        sp.add_argument("--coordinator-address", default=None,
                        help="host:port of process 0 (outside torchrun)")
        sp.add_argument("--num-processes", type=int, default=None)
        sp.add_argument("--process-id", type=int, default=None)
        sp.add_argument("--config", default=None,
                        help="JSON config-tree file (core.config.Config; "
                             "see train.factory.config_to_json). CLI flags "
                             "override its values; training commands write "
                             "the resolved config to <workdir>/config.json")
        sp.add_argument("--force-model-mismatch", action="store_true",
                        help="restore a checkpoint whose stamped "
                             "architecture differs STRUCTURALLY from the "
                             "requested model (train/identity.py)")

    for name in ("am", "lm", "atten", "e2e", "joint", "eval", "eval-lm",
                 "eval-e2e", "eval-atten"):
        sp = sub.add_parser(name)
        common(sp)
        if name in ("am", "eval"):
            sp.add_argument("--model", default="se_dfcnn", choices=AM_NAMES,
                            help="acoustic model architecture; eval must "
                                 "match what `am` trained")
            sp.add_argument("--logits-matmul", default="f32",
                            choices=["f32", "bf16"],
                            help="final vocab-projection matmul: f32 "
                                 "(reference numerics) or bf16 operands "
                                 "with f32 accumulation (same parameter "
                                 "tree, checkpoints interchangeable)")
        if name == "am":
            sp.add_argument("--augment-noise", action="store_true")
        if name in ("am", "e2e"):
            sp.add_argument("--augment-spec", action="store_true",
                            help="SpecAugment time/freq masking in the "
                                 "train step (e2e: before LFR stacking)")
        if name in TRAIN_COMMANDS:
            sp.add_argument("--tensorboard", action="store_true",
                            help="also write TensorBoard event files to "
                                 "<workdir>/tb/<name> (utils/tb_events.py); "
                                 "e2e also writes each dev sweep's "
                                 "attention maps as images")
        if name in ("eval", "eval-e2e"):
            sp.add_argument("--decode", default="greedy",
                            choices=["greedy", "beam"])
            sp.add_argument("--beam-width", type=int, default=8)
            sp.add_argument("--limit", type=int, default=None)
        if name == "eval":
            sp.add_argument("--am-hdf5", default=None,
                            help="load the acoustic model from a Keras "
                                 ".hdf5 weight file instead of the "
                                 "workdir's checkpoint (cnn_ctc layout, "
                                 "e.g. the reference's model_05.7.64.hdf5, "
                                 "or the cnn_rnn_ctc layout with --model "
                                 "bigru; needs h5py)")
            sp.add_argument("--am-tf-ckpt", default=None,
                            help="load the SE-DFCNN acoustic model from a "
                                 "TF1 tensor_bundle checkpoint prefix "
                                 "instead of the workdir's checkpoint")
        if name in ("eval", "eval-lm"):
            sp.add_argument("--lm-tf-ckpt", default=None,
                            help="load the Transformer LM from a TF1 "
                                 "tensor_bundle checkpoint prefix instead "
                                 "of the workdir's checkpoint")

    sp = sub.add_parser("infer")
    common(sp)
    sp.add_argument("--wav", required=True)
    sp.add_argument("--decode", default="greedy", choices=["greedy", "beam"])
    sp.add_argument("--model", default="se_dfcnn", choices=AM_NAMES)
    sp.add_argument("--streaming", action="store_true",
                    help="decode incrementally (IncrementalRecognizer): "
                         "feed the wav in chunks, print a partial "
                         "hypothesis per chunk, then the final")
    sp.add_argument("--chunk-seconds", type=float, default=1.28,
                    help="streaming push size in seconds")

    sp = sub.add_parser(
        "export", help="export the trained AM back to the reference's "
                       "checkpoint formats")
    sp.add_argument("--workdir", required=True)
    sp.add_argument("--out", required=True,
                    help="output path (tf1: checkpoint prefix; "
                         "hdf5: .hdf5 file)")
    sp.add_argument("--format", default="tf1", choices=["tf1", "hdf5"],
                    help="tf1 = tensor_bundle (Saver) files for SE-DFCNN "
                         "(--what am) or the Transformer LM (--what lm); "
                         "hdf5 = Keras cnn_ctc weights (keras_dfcnn) or "
                         "cnn_rnn_ctc weights (--what bigru); needs h5py")
    sp.add_argument("--what", default="am", choices=["am", "lm", "bigru"],
                    help="which trained model to export: the acoustic "
                         "model (am, default), the language model (lm, "
                         "tf1 only), or a keras_parity BiGRU AM (bigru, "
                         "hdf5 only)")
    sp.add_argument("--use-latest", action="store_true",
                    help="export the latest checkpoint instead of the "
                         "metric-gated best")
    sp.add_argument("--platform", default=None)

    sp = sub.add_parser(
        "export-serving",
        help="write the AM -> LM (or e2e) inference programs + weights + "
             "vocabs into ONE artifact (torch.export programs on the "
             "port's kernel ops) servable without model code or "
             "checkpoints")
    common(sp)
    sp.add_argument("--out", required=True, help="artifact path (.zip)")
    sp.add_argument("--what", default="pipeline",
                    choices=["pipeline", "e2e"],
                    help="pipeline = AM -> LM (ServingPipeline); e2e = "
                         "SpeechTransformer encoder + KV-cached decode "
                         "(E2EServing)")
    sp.add_argument("--model", default="se_dfcnn", choices=AM_NAMES)
    sp.add_argument("--decode", default="greedy", choices=["greedy", "beam"])
    sp.add_argument("--beam-width", type=int, default=8)
    sp.add_argument("--no-lm", action="store_true",
                    help="pipeline artifact without the LM stage "
                         "(pinyin only; no ckpt_lm needed)")
    sp.add_argument("--use-latest", action="store_true",
                    help="export the latest checkpoint instead of the "
                         "metric-gated best")
    sp.add_argument("--serve-batch-sizes", default="1,8",
                    help="comma-separated batch sizes to export entry "
                         "points for")
    sp.add_argument("--serve-buckets", default="128,512,1600",
                    help="comma-separated bucket_frames (multiples of 8)")
    sp.add_argument("--serve-platforms", default=None,
                    help="comma-separated devices the artifact is served "
                         "on: cpu, cuda or cpu,cuda, whatever the "
                         "exporting device (default: the exporting "
                         "device's)")

    sp = sub.add_parser(
        "infer-artifact",
        help="recognize a wav from a serving artifact alone: no workdir, "
             "checkpoints or assets")
    sp.add_argument("--artifact", required=True, help=".zip path")
    sp.add_argument("--wav", required=True)
    sp.add_argument("--platform", default=None,
                    help="the device to serve on (default cuda), one of "
                         "the platforms the artifact was exported for")

    sp = sub.add_parser(
        "serve",
        help="HTTP recognition endpoint (infer/http_server.py): POST a PCM "
             "wav to /v1/recognize. Backed by the micro-batching "
             "BatchingServer over a live workdir pipeline, or by a "
             "serving artifact (--artifact; no checkpoints needed)")
    common(sp, workdir_required=False)
    sp.add_argument("--artifact", default=None,
                    help="serve a .zip artifact instead of workdir "
                         "checkpoints")
    sp.add_argument("--host", default="127.0.0.1")
    sp.add_argument("--port", type=int, default=8000,
                    help="0 = pick a free port (printed on startup)")
    sp.add_argument("--model", default="se_dfcnn", choices=AM_NAMES)
    sp.add_argument("--decode", default="greedy", choices=["greedy", "beam"])
    sp.add_argument("--beam-width", type=int, default=8)
    sp.add_argument("--max-batch", type=int, default=16,
                    help="rows per coalesced device batch (live backend)")
    sp.add_argument("--max-wait-ms", type=float, default=5.0,
                    help="batching window after the first pending request")
    sp.add_argument("--max-requests", type=int, default=None,
                    help="exit after N recognitions (smoke tests)")
    sp.add_argument("--streams", type=int, default=0,
                    help="max concurrent /v1/stream sessions (StreamPool-"
                         "batched incremental recognition; 0 = disabled; "
                         "live backend only)")
    sp.add_argument("--stream-idle-timeout", type=float, default=600.0,
                    help="seconds of inactivity before a stream's slot is "
                         "reclaimed")
    return p


def _apply_config(args):
    """Merge a JSON config tree into unset CLI args and, for training
    commands only, snapshot the resolved config into the workdir."""
    from asr_dfcnn_transformer_torch.core.config import Config
    from asr_dfcnn_transformer_torch.train.factory import (config_from_json,
                                                           config_to_json)

    if getattr(args, "config", None):
        with open(args.config, encoding="utf-8") as f:
            cfg = config_from_json(f.read())
    else:
        cfg = Config()
    # CLI flags win; config fills the gaps
    if args.lr is None and args.cmd in ("am", "atten", "joint"):
        args.lr = cfg.am.lr
    if args.lr is None and args.cmd == "lm":
        args.lr = cfg.lm.lr
    if args.lr is None and args.cmd == "e2e":
        args.lr = cfg.e2e.lr
    if args.batch_size is None:
        args.batch_size = {"am": cfg.am.batch_size,
                           "lm": cfg.lm.batch_size,
                           "e2e": cfg.e2e.batch_size}.get(args.cmd)
    if args.epochs is None:
        args.epochs = cfg.train.epochs
    os.makedirs(args.workdir, exist_ok=True)
    # eval / infer resolve defaults too, but the record of what training
    # used must not be overwritten by them
    if args.cmd in TRAIN_COMMANDS and _is_writer():
        eff = cfg
        if args.cmd == "am" and args.lr is not None:
            eff = eff.replace(
                am=dataclasses.replace(eff.am, lr=args.lr,
                                       batch_size=args.batch_size
                                       or eff.am.batch_size))
        with open(os.path.join(args.workdir, "config.json"), "w",
                  encoding="utf-8") as f:
            f.write(config_to_json(eff))
    return cfg


def _data(args, batch_size, bucket_bounds=(400, 800, 1200, 1600),
          e2e_vocab: bool = False):
    from asr_dfcnn_transformer_torch.core import vocab
    from asr_dfcnn_transformer_torch.data import (DataLoader, load_manifests,
                                                  make_synthetic_corpus)

    if args.synthetic:
        root = os.path.join(args.workdir, "synthetic")
        if _is_writer():
            make_synthetic_corpus(root, num_utts=args.synthetic,
                                  num_classes=8, seed=args.seed)
        _barrier()
        data_dir, wav_root = (os.path.join(root, "data"),
                              os.path.join(root, "wav"))
        corpora = ("thchs",)
    else:
        data_dir, wav_root = args.data_dir, args.speech_root
        corpora = tuple(args.corpora.split(","))
        if data_dir is None:
            sys.exit("--data-dir required (or use --synthetic N)")
    av = vocab.acoustic_vocab()
    # the e2e model's hanzi ids put PAD / SOS / EOS first
    lv = vocab.e2e_language_vocab() if e2e_vocab else vocab.language_vocab()

    def loader(mode, shuffle):
        m = load_manifests(data_dir, mode, corpora=corpora, shuffle=shuffle,
                           seed=args.seed)
        return DataLoader(m, av, lv, speech_root=wav_root,
                          noise_root=args.noise_root,
                          bucket_bounds=bucket_bounds)

    return loader, av, lv


def _is_writer() -> bool:
    """True outside a process group and on its rank 0."""
    import torch.distributed as dist
    return not dist.is_initialized() or dist.get_rank() == 0


def _barrier() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.barrier()


def _setup_distributed(args) -> torch.device:
    """``--distributed``: join the process group and return this process's
    device, printing the JAX CLI's line."""
    import torch.distributed as dist

    from asr_dfcnn_transformer_torch.parallel import init_distributed
    init = (f"tcp://{args.coordinator_address}"
            if args.coordinator_address else None)
    device = init_distributed(args.platform, init_method=init,
                              world_size=args.num_processes,
                              rank=args.process_id)
    n = dist.get_world_size()
    print(f"[distributed] process {dist.get_rank()}/{n}, local devices 1, "
          f"global {n}", flush=True)
    return device


def _bounds(args):
    return (128,) if args.synthetic else (400, 800, 1200, 1600)


def _init_generator(args) -> torch.Generator:
    return torch.Generator().manual_seed(args.seed)


def _am_model(args, name: str, vocab_size: int):
    """The JAX CLI's models: ``--small`` ones (f32; the plain DFCNN at full
    width), else the factory's from the resolved config; both with
    ``--logits-matmul``."""
    from asr_dfcnn_transformer_torch import models
    from asr_dfcnn_transformer_torch.train import factory
    lg = getattr(args, "logits_matmul", "f32")
    if args.small:
        kw = dict(logits_matmul=lg, dtype=torch.float32)
        if name == "bigru":
            model, cfg = models.BiGRUCTC, models.BiGRUCTCConfig(
                vocab_size, hidden=32, num_layers=1, **kw)
        elif name == "dfcnn":
            model, cfg = models.DFCNN, models.DFCNNConfig(vocab_size, **kw)
        elif name == "keras_dfcnn":
            model, cfg = models.KerasDFCNN, models.KerasDFCNNConfig(
                vocab_size, dense_units=16, **kw)
        else:
            factory.am_architecture(name)        # unknown names raise
            model, cfg = models.SEDFCNN, models.SEDFCNNConfig(
                vocab_size, stage_features=(4, 4, 8, 8, 8), head_features=8,
                se_first=name == "se_dfcnn_pre", **kw)
        return model(cfg, feature_dim=200, device=args.device,
                     generator=_init_generator(args))
    cfg = args.cfg.replace(am=dataclasses.replace(args.cfg.am, model=name))
    return factory.build_am_model(cfg, args.device, _init_generator(args),
                                  logits_matmul=lg)


def _lm_model(args, av_size: int, lv_size: int):
    from asr_dfcnn_transformer_torch.models import (TransformerLM,
                                                    TransformerLMConfig)
    from asr_dfcnn_transformer_torch.train import factory
    if args.small:
        return TransformerLM(TransformerLMConfig(
            av_size, lv_size, d_model=32, num_heads=4, num_blocks=1,
            dropout_rate=0.0, dtype=torch.float32), device=args.device,
            generator=_init_generator(args))
    return factory.build_lm_model(args.cfg, args.device,
                                  _init_generator(args))


def _e2e_model(args, vocab_size: int):
    """(model, fbank filters): the small model reads 40 filters."""
    from asr_dfcnn_transformer_torch.models import (SpeechTransformer,
                                                    SpeechTransformerConfig)
    from asr_dfcnn_transformer_torch.train import factory
    if args.small:
        e = args.cfg.e2e
        return SpeechTransformer(SpeechTransformerConfig(
            vocab_size, d_model=32, num_heads=4, num_enc_blocks=1,
            num_dec_blocks=1, prenet_channels=8, dropout_rate=0.0,
            dtype=torch.float32), feature_dim=e.lfr_m * 40,
            device=args.device, generator=_init_generator(args)), 40
    return (factory.build_e2e_model(args.cfg, args.device,
                                    _init_generator(args)),
            args.cfg.e2e.feature_dim)


def _step_generator(args) -> torch.Generator:
    return torch.Generator(device=args.device).manual_seed(args.seed)


def _trainer_flags(tr, args):
    tr.allow_model_mismatch = getattr(args, "force_model_mismatch", False)
    if getattr(args, "tensorboard", False):
        tr.enable_tensorboard()
    return tr


def cmd_am(args):
    from asr_dfcnn_transformer_torch.data import prefetch
    from asr_dfcnn_transformer_torch.train import AMTrainer
    bsz = args.batch_size or 16
    loader, av, _ = _data(args, bsz, _bounds(args))
    train_dl, dev_dl = loader("train", True), loader("dev", False)
    model = _am_model(args, args.model, av.size)
    tr = _trainer_flags(AMTrainer(model, args.workdir, lr=args.lr or 7e-4,
                                  augment_noise=args.augment_noise,
                                  augment_spec=args.augment_spec), args)
    tr.restore_or_init()
    out = tr.fit(lambda: prefetch(train_dl.am_batches(bsz, seed=args.seed)),
                 lambda: dev_dl.am_batches(bsz, shuffle=False),
                 epochs=args.epochs or 100, generator=_step_generator(args))
    print("am training done:", out)


def cmd_lm(args):
    from asr_dfcnn_transformer_torch.data import prefetch
    from asr_dfcnn_transformer_torch.train import LMTrainer
    bsz = args.batch_size or 64
    loader, av, lv = _data(args, bsz)
    train_dl, dev_dl = loader("train", True), loader("dev", False)
    tr = _trainer_flags(LMTrainer(_lm_model(args, av.size, lv.size),
                                  args.workdir, lr=args.lr or 5e-5), args)
    tr.restore_or_init()
    out = tr.fit(lambda: prefetch(train_dl.lm_batches(bsz, seed=args.seed)),
                 lambda: dev_dl.lm_batches(bsz, shuffle=False),
                 epochs=args.epochs or 100, generator=_step_generator(args))
    print("lm training done:", out)


def _atten_trainer(args, lv, **kw):
    """The JAX CLI's CTC-attention model (``--small``: d 32, 4 heads, one
    block, f32) over LFR rows of 4 x 200 fbank filters, and its trainer."""
    from asr_dfcnn_transformer_torch.models import (CTCAttention,
                                                    CTCAttentionConfig)
    from asr_dfcnn_transformer_torch.train import AttenTrainer
    cfg = (CTCAttentionConfig(lv.size, d_model=32, num_heads=4, num_blocks=1,
                              dropout_rate=0.0, dtype=torch.float32)
           if args.small else CTCAttentionConfig(lv.size))
    model = CTCAttention(cfg, feature_dim=4 * 200, device=args.device,
                         generator=_init_generator(args))
    return _trainer_flags(AttenTrainer(model, args.workdir, **kw), args)


def cmd_atten(args):
    """CTC-attention: LFR fbank -> hanzi CTC (train_atten.py capability)."""
    from asr_dfcnn_transformer_torch.data import prefetch
    bsz = args.batch_size or 16
    loader, _, lv = _data(args, bsz, _bounds(args))
    train_dl, dev_dl = loader("train", True), loader("dev", False)
    tr = _atten_trainer(args, lv, lr=args.lr or 7e-4)
    tr.restore_or_init()
    out = tr.fit(lambda: prefetch(train_dl.am_batches(bsz, seed=args.seed)),
                 lambda: dev_dl.am_batches(bsz, shuffle=False),
                 epochs=args.epochs or 100, generator=_step_generator(args))
    print("ctc-attention training done:", out)


def cmd_eval_atten(args):
    """Decode the test set with the CTC-attention model (greedy, at most 64
    hanzi an utterance) and print the hanzi accuracy under the
    clipped-edit-distance protocol."""
    from asr_dfcnn_transformer_torch.ops.ctc_decode import ctc_greedy_decode
    from asr_dfcnn_transformer_torch.ops.edit_distance import edit_distance
    bsz = args.batch_size or 16
    loader, _, lv = _data(args, bsz, _bounds(args))
    test_dl = loader("test", False)
    tr = _atten_trainer(args, lv)
    _require_ckpt(tr, "CTC-attention", args.workdir)
    tr.restore_or_init()
    tr.model.eval()
    err = tot = n_utts = 0
    for batch in test_dl.am_batches(bsz, shuffle=False):
        with torch.inference_mode():
            sig, sig_len = tr._to_device(batch.signals, batch.signal_lengths)
            feats, valid = tr.features(sig, sig_len, batch.bucket_frames)
            logits, in_len = tr.model(feats, valid)
            ids, lens = ctc_greedy_decode(logits, in_len, blank_id=-1,
                                          max_output_len=64)
        ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
        for j in range(ids.shape[0]):
            if batch.weights[j] == 0:
                continue
            n_utts += 1
            gt = list(batch.hanzi[j][: batch.hanzi_lengths[j]])
            d = edit_distance(gt, list(ids[j][: lens[j]]))
            err += min(d, len(gt))
            tot += len(gt)
    acc = 1.0 - err / max(tot, 1)
    print(f"*[Test Result] atten 汉字 word accuracy ratio: "
          f"{acc * 100:.2f}% ({n_utts} utts)")


def cmd_joint(args):
    """Jointly trained AM -> LM (the working am_lm_train.py capability):
    the JAX CLI's ``AMLMJoint`` (``--small``: its reduced sizes, f32)."""
    from asr_dfcnn_transformer_torch.data import prefetch
    from asr_dfcnn_transformer_torch.models import AMLMJoint, AMLMJointConfig
    from asr_dfcnn_transformer_torch.train import JointTrainer
    bsz = args.batch_size or 16
    loader, av, lv = _data(args, bsz, _bounds(args))
    train_dl, dev_dl = loader("train", True), loader("dev", False)
    model = AMLMJoint(AMLMJointConfig(
        av.size, lv.size, small=args.small,
        dtype=torch.float32 if args.small else torch.bfloat16),
        device=args.device, generator=_init_generator(args))
    tr = _trainer_flags(JointTrainer(model, args.workdir,
                                     lr=args.lr or 7e-4), args)
    tr.restore_or_init()
    out = tr.fit(lambda: prefetch(train_dl.am_batches(bsz, seed=args.seed)),
                 epochs=args.epochs or 10, generator=_step_generator(args),
                 dev_batches=lambda: dev_dl.am_batches(bsz, shuffle=False))
    print("joint training done:", out)


def _e2e_trainer(args, ev, **kw):
    from asr_dfcnn_transformer_torch.train import E2ETrainer
    model, nfilt = _e2e_model(args, ev.size)
    e = args.cfg.e2e
    tr = E2ETrainer(model, args.workdir, feature_dim=nfilt, lfr_m=e.lfr_m,
                    lfr_n=e.lfr_n, **kw)
    return _trainer_flags(tr, args)


def cmd_e2e(args):
    from asr_dfcnn_transformer_torch.data import prefetch
    bsz = args.batch_size or 8
    loader, _, ev = _data(args, bsz, _bounds(args), e2e_vocab=True)
    train_dl, dev_dl = loader("train", True), loader("dev", False)
    tr = _e2e_trainer(args, ev, lr=args.lr or 3e-4,
                      augment_spec=args.augment_spec)
    tr.restore_or_init()
    out = tr.fit(lambda: prefetch(train_dl.am_batches(bsz, seed=args.seed)),
                 epochs=args.epochs or 10, generator=_step_generator(args),
                 dev_batches=lambda: dev_dl.am_batches(bsz, shuffle=False))
    print("e2e training done:", out)


def cmd_eval_e2e(args):
    """Decode the test set with the e2e speech Transformer (KV-cached
    greedy, or beam of ``--beam-width``) and print the hanzi accuracy
    under the clipped-edit-distance protocol."""
    from asr_dfcnn_transformer_torch.models import (beam_decode_cached,
                                                    greedy_decode_cached)
    from asr_dfcnn_transformer_torch.ops.edit_distance import edit_distance
    bsz = args.batch_size or 8
    loader, _, ev = _data(args, bsz, _bounds(args), e2e_vocab=True)
    test_dl = loader("test", False)
    tr = _e2e_trainer(args, ev)
    _require_ckpt(tr, "end-to-end", args.workdir)
    tr.restore_or_init()
    tr.model.eval()
    err = tot = n_utts = 0
    for batch in test_dl.am_batches(bsz, shuffle=False):
        with torch.inference_mode():
            sig, sig_len = tr._to_device(batch.signals, batch.signal_lengths)
            feats, valid = tr.features(sig, sig_len, batch.bucket_frames)
            if args.decode == "beam":
                ids, lens, _ = beam_decode_cached(
                    tr.model, feats, valid, beam_size=args.beam_width)
            else:
                ids, lens = greedy_decode_cached(tr.model, feats, valid)
        ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
        for j in range(ids.shape[0]):
            if batch.weights[j] == 0:
                continue
            n_utts += 1
            gt = list(batch.hanzi[j][: batch.hanzi_lengths[j]])
            d = edit_distance(gt, list(ids[j][: lens[j]]))
            err += min(d, len(gt))
            tot += len(gt)
    acc = 1.0 - err / max(tot, 1)
    print(f"*[Test Result] e2e 汉字 word accuracy ratio: {acc * 100:.2f}% "
          f"({n_utts} utts, decode={args.decode})")


def cmd_eval_lm(args):
    """LM-only eval on ground-truth pinyin (test_lm.py capability)."""
    pipe, test_dl, bsz = _load_pipeline(args, need_am=False)
    res = pipe.evaluate_lm(
        test_dl.lm_batches(bsz, shuffle=False),
        pred_log_path=os.path.join(args.workdir, "pred", "pred_lm_log"))
    print(f"*[Test Result] 汉字 word accuracy ratio: "
          f"{res.hanzi_accuracy * 100:.2f}%")


def _require_ckpt(trainer, what: str, workdir: str) -> None:
    """Eval / infer must not silently run on random init weights (a
    mistyped --workdir would otherwise give plausible near-zero
    accuracy)."""
    if trainer.ckpt.latest_step() is None:
        hint = " or pass --am-hdf5" if what == "AM" else ""
        raise SystemExit(
            f"error: no {what} checkpoint found under {workdir!r} — "
            f"eval/infer refuses to run on randomly initialized weights. "
            f"Train first{hint}.")


def _load_pipeline(args, decode="greedy", beam_width=8, need_am=True):
    from asr_dfcnn_transformer_torch.convert import (am_state_dict,
                                                     bigru_state_dict,
                                                     lm_state_dict)
    from asr_dfcnn_transformer_torch.infer import Pipeline
    from asr_dfcnn_transformer_torch.infer.tf_ckpt import (load_tf1_lm,
                                                           load_tf1_sedfcnn)
    from asr_dfcnn_transformer_torch.models import (BiGRUCTC, BiGRUCTCConfig,
                                                    KerasDFCNN,
                                                    KerasDFCNNConfig, SEDFCNN,
                                                    SEDFCNNConfig)
    from asr_dfcnn_transformer_torch.train import AMTrainer, LMTrainer
    bsz = args.batch_size or 16
    loader, av, lv = _data(args, bsz, _bounds(args))
    test_dl = loader("test", False)
    lm = _lm_model(args, av.size, lv.size)
    if getattr(args, "lm_tf_ckpt", None):
        lm.load_state_dict(lm_state_dict(load_tf1_lm(
            args.lm_tf_ckpt, av.size, lv.size,
            num_blocks=lm.config.num_blocks)))
    else:
        lmt = _trainer_flags(LMTrainer(lm, args.workdir), args)
        _require_ckpt(lmt, "LM", args.workdir)
        lmt.restore_or_init()
    if getattr(args, "am_hdf5", None):
        from asr_dfcnn_transformer_torch.infer import hdf5_import
        if getattr(args, "model", "se_dfcnn") == "bigru":
            # the hidden width is the file's (its first GRU's kernel)
            raw = hdf5_import.load_keras_bigru_hdf5(args.am_hdf5, av.size)
            hidden = raw["params"]["gru_fwd_0"]["kernel"].shape[1] // 3
            am = BiGRUCTC(BiGRUCTCConfig(av.size, hidden=hidden,
                                         keras_parity=True),
                          device=args.device, generator=_init_generator(args))
            am.load_state_dict(bigru_state_dict(raw))
        else:
            am = KerasDFCNN(KerasDFCNNConfig(av.size), device=args.device,
                            generator=_init_generator(args))
            am.load_state_dict(am_state_dict(
                hdf5_import.load_keras_dfcnn_hdf5(args.am_hdf5, av.size)))
    elif getattr(args, "am_tf_ckpt", None):
        am = SEDFCNN(SEDFCNNConfig(av.size), device=args.device,
                     generator=_init_generator(args))
        am.load_state_dict(am_state_dict(load_tf1_sedfcnn(args.am_tf_ckpt,
                                                          av.size)))
    else:
        am = _am_model(args, getattr(args, "model", "se_dfcnn"), av.size)
        amt = _trainer_flags(AMTrainer(am, args.workdir), args)
        if need_am or amt.ckpt.latest_step() is not None:
            _require_ckpt(amt, "AM", args.workdir)
            amt.restore_or_init()
        # else (LM-only eval): the AM is never run, its init stands in
    pipe = Pipeline(am, lm, acoustic_vocab=av, language_vocab=lv,
                    decode=decode, beam_width=beam_width)
    return pipe, test_dl, bsz


def cmd_eval(args):
    pipe, test_dl, bsz = _load_pipeline(args, args.decode, args.beam_width)
    batches = test_dl.am_batches(bsz, shuffle=False)
    if args.limit:
        batches = itertools.islice(batches, max(1, args.limit // bsz))
    res = pipe.evaluate(batches, pred_log_path=os.path.join(
        args.workdir, "pred", "pred_log"))
    print(f"*[Test Result] 拼音 word accuracy ratio: "
          f"{res.pinyin_accuracy * 100:.2f}%")
    print(f"*[Test Result] 汉字 word accuracy ratio: "
          f"{res.hanzi_accuracy * 100:.2f}%")
    print("pred_log:", res.pred_log_path)


def cmd_infer(args):
    pipe, _, _ = _load_pipeline(args, args.decode)
    if args.streaming:
        from asr_dfcnn_transformer_torch.audio.wav import read_wav
        from asr_dfcnn_transformer_torch.infer.streaming import (
            IncrementalRecognizer)
        sig, sr = read_wav(args.wav)
        rec = IncrementalRecognizer(pipe)
        step = max(1, int(args.chunk_seconds * sr))
        for i in range(0, len(sig), step):
            rec.push(sig[i: i + step])
            pinyin, hanzi = rec.partial()
            print(f"[{min(i + step, len(sig)) / sr:6.2f}s] "
                  f"{' '.join(pinyin)} | {hanzi}", flush=True)
        pinyin, hanzi = rec.finalize()
    else:
        pinyin, hanzi = pipe.recognize_file(args.wav)
    print("拼音:", " ".join(pinyin))
    print("汉字:", hanzi)


def cmd_export(args):
    """Hand a trained model back to the reference stack: a TF1
    tensor_bundle (the AM Saver's names, train.py:38, or the LM's,
    train.py:148) or Keras .hdf5 weights (cnn_ctc.py:85, or the
    cnn_rnn_ctc layout of a keras_parity BiGRU)."""
    from asr_dfcnn_transformer_torch.convert import state_dict_to_flax
    from asr_dfcnn_transformer_torch.infer import Pipeline
    from asr_dfcnn_transformer_torch.infer.tf_ckpt import (export_tf1_lm,
                                                           export_tf1_sedfcnn,
                                                           write_tf_checkpoint)
    if args.what == "lm" and args.format != "tf1":
        raise SystemExit("error: the LM has no Keras layout; use --format "
                         "tf1")
    if args.what == "bigru" and args.format != "hdf5":
        raise SystemExit("error: the BiGRU maps to the Keras cnn_rnn_ctc "
                         "layout; use --format hdf5")
    ckpt_name = "lm" if args.what == "lm" else "am"
    state = Pipeline._restore(args.workdir, ckpt_name,
                              use_best=not args.use_latest)
    if state is None:
        raise SystemExit(f"error: no {ckpt_name.upper()} checkpoint under "
                         f"{args.workdir!r}")
    try:
        variables = state_dict_to_flax(state["model"], args.what)
        if args.what == "lm":
            nb = sum(k.startswith("block0_") and k.endswith("_attn")
                     for k in variables["params"])
            write_tf_checkpoint(args.out,
                                export_tf1_lm(variables, num_blocks=nb))
        elif args.what == "bigru":
            from asr_dfcnn_transformer_torch.infer.hdf5_import import (
                save_keras_bigru_hdf5)
            p = variables["params"]
            save_keras_bigru_hdf5(
                args.out, variables,
                vocab_size=p["Dense_3"]["kernel"].shape[1],
                hidden=p["gru_fwd_0"]["kernel"].shape[1] // 3)
        elif args.format == "tf1":
            write_tf_checkpoint(args.out, export_tf1_sedfcnn(variables))
        else:
            from asr_dfcnn_transformer_torch.infer.hdf5_import import (
                save_keras_dfcnn_hdf5)
            p = variables["params"]
            save_keras_dfcnn_hdf5(
                args.out, variables,
                vocab_size=p["Dense_1"]["kernel"].shape[1],
                dense_units=p["Dense_0"]["kernel"].shape[1])
    except (KeyError, ValueError) as e:
        raise SystemExit(
            f"error: checkpoint layout does not match the {args.what}/"
            f"{args.format} export mapping (tf1 = se_dfcnn family or lm, "
            f"hdf5 = keras_dfcnn or keras_parity bigru); missing {e}")
    print(f"exported {args.what} {args.format} -> {args.out}")


def _csv_ints(text: str):
    return tuple(int(x) for x in text.split(",") if x)


def cmd_export_serving(args):
    """One self-contained serving artifact: the inference programs
    (torch.export) + weights + vocab tables, from the workdir's
    checkpoints (the metric-gated best unless --use-latest) and the asset
    vocabularies; no corpus or trainer state."""
    from asr_dfcnn_transformer_torch.core import vocab as V
    from asr_dfcnn_transformer_torch.infer import export_serving as es
    from asr_dfcnn_transformer_torch.infer.pipeline import Pipeline
    batch_sizes = _csv_ints(args.serve_batch_sizes)
    buckets = _csv_ints(args.serve_buckets)
    platforms = (tuple(args.serve_platforms.split(","))
                 if args.serve_platforms else None)
    use_best = not args.use_latest
    mismatch = getattr(args, "force_model_mismatch", False)
    try:
        if args.what == "e2e":
            ev = V.e2e_language_vocab()
            model, nfilt = _e2e_model(args, ev.size)
            state = Pipeline._restore(args.workdir, "e2e", use_best, model,
                                      mismatch)
            if state is None:
                raise SystemExit(f"error: no end-to-end checkpoint under "
                                 f"{args.workdir!r}")
            model.load_state_dict(state["model"])
            e = args.cfg.e2e
            meta = es.export_e2e(
                model, args.out, vocab=ev, feature_dim=nfilt, lfr_m=e.lfr_m,
                lfr_n=e.lfr_n, decode=args.decode,
                beam_width=(args.beam_width if args.decode == "beam"
                            else 3),
                batch_sizes=batch_sizes, buckets=buckets,
                platforms=platforms)
        else:
            av, lv = V.acoustic_vocab(), V.language_vocab()
            am = _am_model(args, args.model, av.size)
            lm = None if args.no_lm else _lm_model(args, av.size, lv.size)
            pipe = Pipeline.from_checkpoints(
                args.workdir, am, lm, acoustic_vocab=av,
                language_vocab=None if args.no_lm else lv,
                use_best=use_best, decode=args.decode,
                beam_width=args.beam_width, allow_model_mismatch=mismatch)
            meta = es.export_pipeline(pipe, args.out,
                                      batch_sizes=batch_sizes,
                                      buckets=buckets, platforms=platforms)
    except ValueError as e:
        raise SystemExit(f"error: {e}")
    walls = ", ".join(f"{k} {v:.1f} s"
                      for k, v in meta["export_seconds"].items())
    print(f"exported serving artifact -> {args.out} "
          f"(kind={meta['kind']}, {len(meta['programs'])} entry points, "
          f"decode={meta['decode']}, device={meta['device']}, platforms="
          f"{','.join(meta['platforms'])}; {walls})")


def _load_artifact(args):
    from asr_dfcnn_transformer_torch.core.device import default_device
    from asr_dfcnn_transformer_torch.infer.export_serving import (
        load_artifact)
    try:
        return load_artifact(args.artifact,
                             device=default_device(args.platform))
    except (ValueError, RuntimeError) as e:   # not its device; no CUDA
        raise SystemExit(f"error: {e}")


def cmd_infer_artifact(args):
    """Artifact-only recognition: load_artifact + recognize, nothing else
    (the deployment-side counterpart of `infer`)."""
    from asr_dfcnn_transformer_torch.audio.wav import read_wav
    from asr_dfcnn_transformer_torch.infer.export_serving import E2EServing
    served = _load_artifact(args)
    sig, _ = read_wav(args.wav)
    if isinstance(served, E2EServing):
        print("汉字:", served.recognize_signal(sig))
    else:
        pinyin, hanzi = served.recognize_signal(sig)
        print("拼音:", " ".join(pinyin))
        if served.language_vocab is not None:   # a --no-lm artifact has
            print("汉字:", hanzi)               # no hanzi stage at all


def cmd_serve(args):
    """HTTP recognition endpoint over a live pipeline (micro-batched) or
    a serving artifact."""
    import time

    from asr_dfcnn_transformer_torch.infer.http_server import (
        HTTPRecognitionServer)
    if args.streams and args.artifact:
        raise SystemExit("serve: --streams needs a live --workdir backend")
    if args.artifact:
        backend = _load_artifact(args)
        bounds = (400, 800, 1200, 1600)
    else:
        if not args.workdir:
            raise SystemExit(
                "serve: pass --workdir (live checkpoints) or --artifact")
        backend, _, _ = _load_pipeline(args, args.decode, args.beam_width)
        bounds = _bounds(args)
    srv = HTTPRecognitionServer(
        backend, host=args.host, port=args.port,
        max_batch=args.max_batch, max_wait_ms=args.max_wait_ms,
        bucket_bounds=bounds, streams=args.streams,
        stream_kw={"idle_timeout_s": args.stream_idle_timeout}
        if args.streams else None)
    print(f"serving on http://{args.host}:{srv.port} "
          f"(backend: {srv._backend.kind}"
          + (f", {args.streams} stream slots" if args.streams else "")
          + ")", flush=True)
    if args.max_requests:
        srv.start()
        while srv.requests_served < args.max_requests:
            time.sleep(0.05)
        srv.close()
        return
    try:
        srv.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        srv.close()


COMMANDS = {"am": cmd_am, "lm": cmd_lm, "atten": cmd_atten, "e2e": cmd_e2e,
            "joint": cmd_joint, "eval": cmd_eval, "eval-lm": cmd_eval_lm,
            "eval-e2e": cmd_eval_e2e, "eval-atten": cmd_eval_atten,
            "infer": cmd_infer, "export": cmd_export,
            "export-serving": cmd_export_serving,
            "infer-artifact": cmd_infer_artifact, "serve": cmd_serve}


def main(argv=None):
    from asr_dfcnn_transformer_torch.core.device import default_device
    args = _build_parser().parse_args(argv)
    # export reads checkpoints into host memory and infer-artifact needs
    # no workdir; every other command runs on the device and resolves the
    # config (training ones snapshot it)
    if getattr(args, "distributed", False):
        args.device = _setup_distributed(args)
    elif args.cmd not in ("export", "infer-artifact"):
        args.device = default_device(args.platform)
    if args.cmd not in ("export", "infer-artifact") and \
            getattr(args, "workdir", None):
        args.cfg = _apply_config(args)
    try:
        COMMANDS[args.cmd](args)
    finally:
        if getattr(args, "distributed", False):
            from asr_dfcnn_transformer_torch.parallel import destroy
            destroy()


if __name__ == "__main__":
    main()
