"""Command-line entry points: the port of ``train/cli.py``.

    python -m asr_dfcnn_transformer_torch.train.cli am       --workdir W [...]
    python -m asr_dfcnn_transformer_torch.train.cli lm       --workdir W [...]
    python -m asr_dfcnn_transformer_torch.train.cli e2e      --workdir W [...]
    python -m asr_dfcnn_transformer_torch.train.cli eval     --workdir W [...]
    python -m asr_dfcnn_transformer_torch.train.cli eval-lm  --workdir W [...]
    python -m asr_dfcnn_transformer_torch.train.cli eval-e2e --workdir W [...]
    python -m asr_dfcnn_transformer_torch.train.cli infer    --workdir W --wav f.wav
    python -m asr_dfcnn_transformer_torch.train.cli export   --workdir W --out P [--what am|lm]

The JAX CLI's commands, flags and defaults, on the port's models, trainers
and kernels; the accuracy lines are printed in the JAX CLI's words, so a
script reads either package's output. Everything runs on the card (CUDA;
the command raises without it) unless ``--platform cpu``. The full-width
models are built through ``train/factory.py`` from the resolved config, so
``--config`` reaches their kernel selectors (``fused_ffn="pallas"``); with
the default config they are the JAX CLI's models field for field, and
``--small`` builds the JAX CLI's small models. ``--synthetic N`` writes the
JAX CLI's tone corpus under ``<workdir>/synthetic``.

Not ported yet, each with its ROADMAP Queue A item: ``atten``, ``joint``
and ``eval-atten`` (A 11), ``infer --streaming`` (A 8), ``export --format
hdf5`` and ``eval --am-hdf5`` (A 4), ``export-serving``, ``infer-artifact``
and ``serve`` (A 8, A 2), ``--tensorboard`` (A 5.7), ``--distributed``
(A 12).
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
TRAIN_COMMANDS = ("am", "lm", "e2e")


def _build_parser():
    p = argparse.ArgumentParser(prog="asr-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def common(sp):
        sp.add_argument("--workdir", required=True)
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
        sp.add_argument("--config", default=None,
                        help="JSON config-tree file (core.config.Config; "
                             "see train.factory.config_to_json). CLI flags "
                             "override its values; training commands write "
                             "the resolved config to <workdir>/config.json")
        sp.add_argument("--force-model-mismatch", action="store_true",
                        help="restore a checkpoint whose stamped "
                             "architecture differs STRUCTURALLY from the "
                             "requested model (train/identity.py)")

    for name in ("am", "lm", "e2e", "eval", "eval-lm", "eval-e2e"):
        sp = sub.add_parser(name)
        common(sp)
        if name in ("am", "eval"):
            sp.add_argument("--model", default="se_dfcnn", choices=AM_NAMES,
                            help="acoustic model architecture; eval must "
                                 "match what `am` trained (the port builds "
                                 "se_dfcnn, se_dfcnn_pre and se_dfcnn_fast)")
        if name == "am":
            sp.add_argument("--augment-noise", action="store_true")
        if name in ("am", "e2e"):
            sp.add_argument("--augment-spec", action="store_true",
                            help="SpecAugment time/freq masking in the "
                                 "train step (e2e: before LFR stacking)")
        if name in ("eval", "eval-e2e"):
            sp.add_argument("--decode", default="greedy",
                            choices=["greedy", "beam"])
            sp.add_argument("--beam-width", type=int, default=8)
            sp.add_argument("--limit", type=int, default=None)
        if name == "eval":
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

    sp = sub.add_parser(
        "export", help="export a trained model to the reference's TF1 "
                       "checkpoint format")
    sp.add_argument("--workdir", required=True)
    sp.add_argument("--out", required=True,
                    help="output path (tf1: checkpoint prefix)")
    sp.add_argument("--format", default="tf1", choices=["tf1", "hdf5"],
                    help="tf1 = tensor_bundle (Saver) files for SE-DFCNN "
                         "(--what am) or the Transformer LM (--what lm); "
                         "hdf5 is not ported yet (ROADMAP Queue A 4)")
    sp.add_argument("--what", default="am", choices=["am", "lm", "bigru"])
    sp.add_argument("--use-latest", action="store_true",
                    help="export the latest checkpoint instead of the "
                         "metric-gated best")
    sp.add_argument("--platform", default=None)
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
    if args.lr is None and args.cmd == "am":
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
    if args.cmd in TRAIN_COMMANDS:
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
        data_dir, wav_root, _, _ = make_synthetic_corpus(
            root, num_utts=args.synthetic, num_classes=8, seed=args.seed)
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


def _bounds(args):
    return (128,) if args.synthetic else (400, 800, 1200, 1600)


def _init_generator(args) -> torch.Generator:
    return torch.Generator().manual_seed(args.seed)


def _am_model(args, name: str, vocab_size: int):
    from asr_dfcnn_transformer_torch.models import SEDFCNN, SEDFCNNConfig
    from asr_dfcnn_transformer_torch.train import factory
    if args.small:
        factory.am_architecture(name)        # unported names raise
        cfg = SEDFCNNConfig(vocab_size, stage_features=(4, 4, 8, 8, 8),
                            head_features=8,
                            se_first=name == "se_dfcnn_pre",
                            dtype=torch.float32)
        return SEDFCNN(cfg, feature_dim=200, device=args.device,
                       generator=_init_generator(args))
    cfg = args.cfg.replace(am=dataclasses.replace(args.cfg.am, model=name))
    return factory.build_am_model(cfg, args.device, _init_generator(args))


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
        hint = " or pass --am-tf-ckpt" if what == "AM" else ""
        raise SystemExit(
            f"error: no {what} checkpoint found under {workdir!r} — "
            f"eval/infer refuses to run on randomly initialized weights. "
            f"Train first{hint}.")


def _load_pipeline(args, decode="greedy", beam_width=8, need_am=True):
    from asr_dfcnn_transformer_torch.convert import (am_state_dict,
                                                     lm_state_dict)
    from asr_dfcnn_transformer_torch.infer import Pipeline
    from asr_dfcnn_transformer_torch.infer.tf_ckpt import (load_tf1_lm,
                                                           load_tf1_sedfcnn)
    from asr_dfcnn_transformer_torch.models import SEDFCNN, SEDFCNNConfig
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
    if getattr(args, "am_tf_ckpt", None):
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
    pinyin, hanzi = pipe.recognize_file(args.wav)
    print("拼音:", " ".join(pinyin))
    print("汉字:", hanzi)


def cmd_export(args):
    """Hand a trained model back to the reference stack as a TF1
    tensor_bundle (the AM Saver's names, train.py:38, or the LM's,
    train.py:148)."""
    from asr_dfcnn_transformer_torch.convert import state_dict_to_flax
    from asr_dfcnn_transformer_torch.infer import Pipeline
    from asr_dfcnn_transformer_torch.infer.tf_ckpt import (export_tf1_lm,
                                                           export_tf1_sedfcnn,
                                                           write_tf_checkpoint)
    if args.format != "tf1" or args.what == "bigru":
        raise SystemExit("error: the Keras hdf5 export is not ported yet "
                         "(ROADMAP Queue A 4); use --format tf1 --what am|lm")
    state = Pipeline._restore(args.workdir, args.what,
                              use_best=not args.use_latest)
    if state is None:
        raise SystemExit(f"error: no {args.what.upper()} checkpoint under "
                         f"{args.workdir!r}")
    variables = state_dict_to_flax(state["model"], args.what)
    try:
        if args.what == "lm":
            nb = sum(k.startswith("block0_") and k.endswith("_attn")
                     for k in variables["params"])
            tensors = export_tf1_lm(variables, num_blocks=nb)
        else:
            tensors = export_tf1_sedfcnn(variables)
    except KeyError as e:
        raise SystemExit(
            f"error: checkpoint layout does not match the {args.what}/tf1 "
            f"export mapping (se_dfcnn family or lm); missing {e}")
    write_tf_checkpoint(args.out, tensors)
    print(f"exported {args.what} {args.format} -> {args.out}")


COMMANDS = {"am": cmd_am, "lm": cmd_lm, "e2e": cmd_e2e, "eval": cmd_eval,
            "eval-lm": cmd_eval_lm, "eval-e2e": cmd_eval_e2e,
            "infer": cmd_infer, "export": cmd_export}


def main(argv=None):
    from asr_dfcnn_transformer_torch.core.device import default_device
    args = _build_parser().parse_args(argv)
    # export reads checkpoints into host memory; every other command runs
    # on the device and resolves the config (training ones snapshot it)
    if args.cmd != "export":
        args.device = default_device(args.platform)
        args.cfg = _apply_config(args)
    COMMANDS[args.cmd](args)


if __name__ == "__main__":
    main()
