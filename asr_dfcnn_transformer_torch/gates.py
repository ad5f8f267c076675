"""The synthetic-corpus accuracy gates: train small models from scratch on
the tone corpus and score them on its unseen test split.

The port of the JAX package's
``tests/test_synthetic_{cer,fast,e2e,atten,joint,bigru}_gate.py`` with their
corpora, seeds, widths, steps, learning rates and thresholds, plus the beam
gate (the cer gate's trained weights decoded with the prefix beam search). They are the one check that catches an accuracy fault end to end:
a CTC gradient that is wrong but finite, a decode or an LM that loses
tokens. The initial weights come from ``torch.Generator`` s, so they differ
from the JAX package's, but follow the same initializers.

``tests/test_torch_gates.py`` runs them on the CPU (marked slow);
``chip_smoke.py`` phase 15 on the card, where they drive the training
kernels (``ctc_alpha``, ``ctc_beta_xi``, the masked and dual-axis attention
backwards) to a trained model.
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Dict, Optional, Tuple

import torch

# the JAX gates' thresholds
AM_LM_MIN_ACCURACY = 0.97        # pinyin and hanzi, cer and fast gates
E2E_MIN_TEACHER_FORCED = 0.95    # the last training step's accuracy
E2E_MIN_ACCURACY = 0.85          # cached greedy hanzi on the test split
E2E_MIN_UTTERANCES = 100
BEAM_SLACK = 0.01                # beam >= greedy - this, pinyin and hanzi
ATTEN_MIN_ACCURACY = 0.8         # held-out hanzi, 1 - LER
JOINT_MIN_LM_ACC = 0.92          # held-out lm_acc through the AM's decode
BIGRU_MIN_ACCURACY = 0.65        # held-out pinyin, 1 - LER


@contextlib.contextmanager
def _reproducible(on: bool = True):
    """PyTorch's deterministic algorithms (``on``) for the length of a gate,
    the settings restored after it. On the card cuDNN's default convolution
    backward and ``scatter_add_`` (the CTC backward) add in an order that
    changes from run to run, and the e2e gate's accuracies varied with it
    between runs of the same code; the JAX gates run on XLA, whose results
    repeat. An operation with no deterministic version warns (``warn_only``)
    rather than stopping the gate."""
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.is_deterministic_algorithms_warn_only_enabled())
    torch.use_deterministic_algorithms(on, warn_only=True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(before[0], warn_only=before[1])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def corpus(root: str, num_utts: int, syllables=(2, 4), tone_ms: int = 250,
           bucket: int = 128):
    """(train loader, test loader, acoustic vocab, language vocab) over the
    gates' synthetic corpus: ``num_utts`` utterances a split, 4 tone
    classes, ``syllables`` syllables of ``tone_ms`` (2-4 of 250 ms but in
    the BiGRU gate), seed 42, one bucket of ``bucket`` frames."""
    from asr_dfcnn_transformer_torch.core import vocab
    from asr_dfcnn_transformer_torch.data import (DataLoader, load_manifests,
                                                  make_synthetic_corpus)
    data_dir, wav_root, _, _ = make_synthetic_corpus(
        os.path.join(root, "corpus"), num_utts=num_utts, num_classes=4,
        syllables_per_utt=syllables, tone_ms=tone_ms, seed=42)
    av, lv = vocab.acoustic_vocab(), vocab.language_vocab()

    def mk(mode):
        return DataLoader(load_manifests(data_dir, mode, corpora=("thchs",)),
                          av, lv, speech_root=wav_root,
                          bucket_bounds=(bucket,))

    return mk("train"), mk("test"), av, lv


def train_am_lm(root: str, device, fast: bool = False):
    """The cer gate's training (the fast gate's with ``fast``): an f32
    SE-DFCNN 12/12/24/24/24 (head 24, dropout 0) for 500 steps at lr
    1.5e-3, then an f32 LM d 64 x 4 heads x 2 blocks (dropout 0) for 240
    steps at lr 2e-3, batch 8 over 96 utterances. -> (AM, LM, test
    loader, vocabs, {wall seconds, last losses})."""
    from asr_dfcnn_transformer_torch.models import (SEDFCNN, SEDFCNNConfig,
                                                    TransformerLM,
                                                    TransformerLMConfig)
    from asr_dfcnn_transformer_torch.train import AMTrainer, LMTrainer
    device = torch.device(device)
    train_dl, test_dl, av, lv = corpus(root, 96)
    arch = dict(stage_pool=(True, True, False, False, False),
                space_to_depth=True) if fast else {}
    am = SEDFCNN(SEDFCNNConfig(av.size, stage_features=(12, 12, 24, 24, 24),
                               head_features=24, dropout_rate=0.0,
                               dtype=torch.float32, **arch),
                 device=device, generator=torch.Generator().manual_seed(0))
    work = os.path.join(root, "work")
    amt = AMTrainer(am, work, lr=1.5e-3)
    amt.restore_or_init()
    gen = torch.Generator(device=device).manual_seed(1)
    batches = list(train_dl.am_batches(8, shuffle=False))
    t0 = time.perf_counter()
    for step in range(500):
        am_loss = amt.train_step(batches[step % len(batches)], gen)["loss"]
    _sync(device)
    t_am = time.perf_counter() - t0

    lm = TransformerLM(TransformerLMConfig(av.size, lv.size, d_model=64,
                                           num_heads=4, num_blocks=2,
                                           dropout_rate=0.0,
                                           dtype=torch.float32),
                       device=device,
                       generator=torch.Generator().manual_seed(1))
    lmt = LMTrainer(lm, work, lr=2e-3)
    lmt.restore_or_init()
    lm_batches = list(train_dl.lm_batches(8, shuffle=False))
    t0 = time.perf_counter()
    for step in range(240):
        lm_loss = lmt.train_step(lm_batches[step % len(lm_batches)],
                                 gen)["loss"]
    _sync(device)
    t_lm = time.perf_counter() - t0
    return am, lm, test_dl, av, lv, {
        "am_train_s": t_am, "lm_train_s": t_lm,
        "am_last_loss": float(am_loss), "lm_last_loss": float(lm_loss)}


def evaluate(am, lm, test_dl, av, lv, decode: str = "greedy"):
    """``Pipeline.evaluate`` over the test split (batch 8) -> (result,
    wall seconds)."""
    from asr_dfcnn_transformer_torch.infer import Pipeline
    pipe = Pipeline(am, lm, acoustic_vocab=av, language_vocab=lv,
                    decode=decode, beam_width=8)
    t0 = time.perf_counter()
    res = pipe.evaluate(test_dl.am_batches(8, shuffle=False))
    _sync(pipe.device)
    return res, time.perf_counter() - t0


@_reproducible()
def am_lm_gate(root: str, device, fast: bool = False,
               beam: bool = False) -> Dict[str, float]:
    """The cer gate (``fast``: the fast gate): train, then the greedy
    accuracies; with ``beam`` also the beam gate's on the same weights."""
    t0 = time.perf_counter()
    am, lm, test_dl, av, lv, out = train_am_lm(root, device, fast)
    res, out["eval_s"] = evaluate(am, lm, test_dl, av, lv)
    out.update(pinyin=res.pinyin_accuracy, hanzi=res.hanzi_accuracy,
               utterances=res.num_utterances)
    if beam:
        res_b, out["beam_eval_s"] = evaluate(am, lm, test_dl, av, lv,
                                             "beam")
        out.update(beam_pinyin=res_b.pinyin_accuracy,
                   beam_hanzi=res_b.hanzi_accuracy,
                   beam_utterances=res_b.num_utterances)
    out["wall_s"] = time.perf_counter() - t0
    return out


def am_lm_misses(out: Dict[str, float]) -> list:
    """The cer / fast / beam gates' failed conditions (empty: passed)."""
    bad = []
    if out["utterances"] != 96:
        bad.append(f"{out['utterances']} test utterances, not 96")
    for key in ("pinyin", "hanzi"):
        if not out[key] > AM_LM_MIN_ACCURACY:
            bad.append(f"{key} accuracy {out[key]:.4f} <= "
                       f"{AM_LM_MIN_ACCURACY}")
        if f"beam_{key}" in out and \
                not out[f"beam_{key}"] >= out[key] - BEAM_SLACK:
            bad.append(f"beam {key} accuracy {out[f'beam_{key}']:.4f} < "
                       f"greedy {out[key]:.4f} - {BEAM_SLACK}")
    return bad


def e2e_gate(root: str, device, init_seed: int = 0,
             deterministic: bool = True,
             initial_state: Optional[dict] = None) -> Dict[str, float]:
    """The e2e gate: an f32 ``SpeechTransformer`` (d 64, 4 heads, 2 + 2
    blocks, pre-net 16, dropout 0) over 40-filter fbank (LFR 4 / 3) for 900
    steps at lr 2e-3, batch 8 over 144 utterances; then the KV-cached
    greedy decode of the test split, scored by clipped edit distance.

    The gate's own run takes the defaults. ``init_seed`` seeds the initial
    weights, ``initial_state`` replaces them (a state dict), and
    ``deterministic`` False keeps PyTorch's default algorithms: the knobs
    ``gate_spread`` turns to see how far the outcome moves."""
    with _reproducible(deterministic):
        return _e2e_gate(root, device, init_seed, initial_state)


def _e2e_gate(root, device, init_seed, initial_state) -> Dict[str, float]:
    from asr_dfcnn_transformer_torch.models import (SpeechTransformer,
                                                    SpeechTransformerConfig,
                                                    greedy_decode_cached)
    from asr_dfcnn_transformer_torch.ops.edit_distance import edit_distance
    from asr_dfcnn_transformer_torch.train import E2ETrainer
    device = torch.device(device)
    t_all = time.perf_counter()
    train_dl, test_dl, _, lv = corpus(root, 144)
    model = SpeechTransformer(SpeechTransformerConfig(
        lv.size, d_model=64, num_heads=4, num_enc_blocks=2, num_dec_blocks=2,
        prenet_channels=16, dropout_rate=0.0, dtype=torch.float32),
        feature_dim=4 * 40, device=device,
        generator=torch.Generator().manual_seed(init_seed))
    if initial_state is not None:
        model.load_state_dict(initial_state, strict=True)
    tr = E2ETrainer(model, os.path.join(root, "work"), lr=2e-3,
                    feature_dim=40)
    tr.restore_or_init()
    gen = torch.Generator(device=device).manual_seed(1)
    batches = list(train_dl.am_batches(8, shuffle=False))
    t0 = time.perf_counter()
    accs = []
    for step in range(900):
        m = tr.train_step(batches[step % len(batches)], gen)
        accs.append(m["acc"])
    final_acc = float(m["acc"])
    last_epoch = torch.stack(accs[-len(batches):])
    t_train = time.perf_counter() - t0

    model.eval()
    err = tot = n_utts = 0
    t0 = time.perf_counter()
    for batch in test_dl.am_batches(8, shuffle=False):
        with torch.inference_mode():
            sig, sig_len = tr._to_device(batch.signals, batch.signal_lengths)
            feats, valid = tr.features(sig, sig_len, batch.bucket_frames)
            ids, lens = greedy_decode_cached(model, feats, valid)
        ids, lens = ids.cpu().numpy(), lens.cpu().numpy()
        for j in range(ids.shape[0]):
            if batch.weights[j] == 0:
                continue
            n_utts += 1
            gt = list(batch.hanzi[j][: batch.hanzi_lengths[j]])
            d = edit_distance(gt, list(ids[j][: lens[j]]))
            err += min(d, len(gt))
            tot += len(gt)
    return {"teacher_forced": final_acc, "hanzi": 1.0 - err / max(tot, 1),
            "utterances": n_utts, "last_loss": float(m["loss"]),
            "last_epoch_acc": float(last_epoch.mean()),
            "last_epoch_min": float(last_epoch.min()), "train_s": t_train,
            "eval_s": time.perf_counter() - t0,
            "wall_s": time.perf_counter() - t_all}


def e2e_misses(out: Dict[str, float]) -> list:
    """The e2e gate's failed conditions (empty: passed)."""
    bad = []
    if not out["teacher_forced"] > E2E_MIN_TEACHER_FORCED:
        bad.append(f"teacher-forced accuracy {out['teacher_forced']:.4f} "
                   f"<= {E2E_MIN_TEACHER_FORCED}")
    if out["utterances"] < E2E_MIN_UTTERANCES:
        bad.append(f"{out['utterances']} test utterances < "
                   f"{E2E_MIN_UTTERANCES}")
    if not out["hanzi"] > E2E_MIN_ACCURACY:
        bad.append(f"hanzi accuracy {out['hanzi']:.4f} <= "
                   f"{E2E_MIN_ACCURACY}")
    return bad


def _train_and_score(trainer, train_dl, test_dl, steps: int, device,
                     key: str) -> Dict[str, float]:
    """``steps`` train steps over the train split's batches of 8 in order
    (the dropout generator seeded 1), then the weight-aware dev mean of
    the eval steps' ``key`` over the test split."""
    from asr_dfcnn_transformer_torch.train.trainer import _dev_mean
    trainer.restore_or_init()
    gen = torch.Generator(device=device).manual_seed(1)
    batches = list(train_dl.am_batches(8, shuffle=False))
    t0 = time.perf_counter()
    for step in range(steps):
        m = trainer.train_step(batches[step % len(batches)], gen)
    _sync(device)
    t_train = time.perf_counter() - t0
    t0 = time.perf_counter()
    evals = [trainer.eval_step(b)
             for b in test_dl.am_batches(8, shuffle=False)]
    return {key: _dev_mean(evals, key), "last_loss": float(m["loss"]),
            "train_s": t_train, "eval_s": time.perf_counter() - t0}


@_reproducible()
def atten_gate(root: str, device) -> Dict[str, float]:
    """The CTC-attention gate: an f32 ``CTCAttention`` (d 64, 4 heads, 2
    blocks, dropout 0, the reference's ``ceil(T/4)`` lengths) over
    40-filter fbank (LFR 4 / 3) for 400 steps at lr 1e-3, batch 8 over 96
    utterances; ``accuracy`` = 1 - the held-out hanzi LER."""
    from asr_dfcnn_transformer_torch.models import (CTCAttention,
                                                    CTCAttentionConfig)
    from asr_dfcnn_transformer_torch.train import AttenTrainer
    device = torch.device(device)
    train_dl, test_dl, _, lv = corpus(root, 96)
    model = CTCAttention(CTCAttentionConfig(
        lv.size, d_model=64, num_heads=4, num_blocks=2, dropout_rate=0.0,
        parity_lengths=True, dtype=torch.float32), feature_dim=4 * 40,
        device=device, generator=torch.Generator().manual_seed(0))
    tr = AttenTrainer(model, os.path.join(root, "work"), lr=1e-3,
                      feature_dim=40)
    out = _train_and_score(tr, train_dl, test_dl, 400, device, "ler")
    out["accuracy"] = 1.0 - out["ler"]
    return out


@_reproducible()
def joint_gate(root: str, device) -> Dict[str, float]:
    """The joint gate: the small f32 ``AMLMJoint`` over 40-filter fbank for
    450 steps at lr 1.5e-3, batch 8 over 96 utterances; ``lm_acc`` is the
    held-out hanzi accuracy of the LM on the AM's own greedy pinyin."""
    from asr_dfcnn_transformer_torch.models import AMLMJoint, AMLMJointConfig
    from asr_dfcnn_transformer_torch.train import JointTrainer
    device = torch.device(device)
    train_dl, test_dl, av, lv = corpus(root, 96)
    model = AMLMJoint(AMLMJointConfig(av.size, lv.size, small=True,
                                      dtype=torch.float32),
                      feature_dim=40, device=device,
                      generator=torch.Generator().manual_seed(0))
    tr = JointTrainer(model, os.path.join(root, "work"), lr=1.5e-3,
                      feature_dim=40)
    return _train_and_score(tr, train_dl, test_dl, 450, device, "lm_acc")


@_reproducible()
def bigru_gate(root: str, device) -> Dict[str, float]:
    """The BiGRU gate: an f32 ``BiGRUCTC`` (hidden 48, 1 layer, dropout 0.1)
    through ``AMTrainer`` over 40-filter fbank for 700 steps at lr 2e-3,
    batch 8 over 160 utterances of 2-3 syllables of 200 ms in 64-frame
    buckets; ``accuracy`` = 1 - the held-out pinyin LER."""
    from asr_dfcnn_transformer_torch.models import BiGRUCTC, BiGRUCTCConfig
    from asr_dfcnn_transformer_torch.train import AMTrainer
    device = torch.device(device)
    train_dl, test_dl, av, _ = corpus(root, 160, (2, 3), 200, 64)
    model = BiGRUCTC(BiGRUCTCConfig(av.size, hidden=48, num_layers=1,
                                    dropout_rate=0.1, dtype=torch.float32),
                     feature_dim=40, device=device,
                     generator=torch.Generator().manual_seed(0))
    tr = AMTrainer(model, os.path.join(root, "work"), lr=2e-3,
                   feature_dim=40)
    out = _train_and_score(tr, train_dl, test_dl, 700, device, "ler")
    out["accuracy"] = 1.0 - out["ler"]
    return out


#: gate -> (its function, the key it is scored by, the floor above which
#: that key must lie)
SCORED_GATES = {"atten": (atten_gate, "accuracy", ATTEN_MIN_ACCURACY),
                "joint": (joint_gate, "lm_acc", JOINT_MIN_LM_ACC),
                "bigru": (bigru_gate, "accuracy", BIGRU_MIN_ACCURACY)}


def scored_misses(gate: str, out: Dict[str, float]) -> list:
    """A scored gate's failed condition (empty: passed)."""
    _, key, floor = SCORED_GATES[gate]
    return [] if out[key] > floor else [f"{gate} {key} {out[key]:.4f} <= "
                                        f"{floor}"]


GATES = ("cer", "fast", "e2e") + tuple(SCORED_GATES)


def run(gate: str, device) -> Tuple[Dict[str, float], list]:
    """One gate in a temporary directory -> (its numbers, its misses);
    the cer gate includes the beam gate."""
    with tempfile.TemporaryDirectory(prefix=f"gate_{gate}_") as root:
        if gate == "e2e":
            out = e2e_gate(root, device)
            return out, e2e_misses(out)
        if gate in SCORED_GATES:
            t0 = time.perf_counter()
            out = SCORED_GATES[gate][0](root, device)
            out["wall_s"] = time.perf_counter() - t0
            return out, scored_misses(gate, out)
        out = am_lm_gate(root, device, fast=gate == "fast",
                         beam=gate == "cer")
        return out, am_lm_misses(out)

