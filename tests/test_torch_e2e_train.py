"""The port's e2e training path against the JAX package's ``E2ETrainer``.

One step at f32 and small widths, dropout 0, on Flax weights bridged by
convert.py: the loss, the accuracy, the learning rate, every parameter's
gradient and the pre-net's updated BatchNorm statistics. The JAX model runs
``prenet_fused="pallas"`` and ``fused_attention="pallas"``, so
``dual_axis_attention`` and ``masked_flash_attention`` and their custom
VJPs run interpreted; its optimizer is swapped for one that hands the
gradients back in its state (as in tests/test_torch_train.py). Both steps
read the JAX front end's features (the port's fbank is held to it in
tests/test_torch_fbank.py, the LFR in tests/test_torch_lfr.py). Then
``e2e_loss`` and ``make_decoder_io`` alone, ``eval_step``'s weight, a
seeded step with dropout and SpecAugment, and ``fit``'s checkpoints, epoch
marker, resume and best-model gate.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asr_dfcnn_transformer_tpu import models as jm
from asr_dfcnn_transformer_tpu.audio import batched_fbank as jax_fbank
from asr_dfcnn_transformer_tpu.audio.fbank import FbankConfig as JaxFbankConfig
from asr_dfcnn_transformer_tpu.audio.lfr import batched_lfr as jax_lfr
from asr_dfcnn_transformer_tpu.data.loader import AMBatch as JaxAMBatch
from asr_dfcnn_transformer_tpu.models.speech_transformer import (
    e2e_loss as jax_e2e_loss,
)
from asr_dfcnn_transformer_tpu.parallel import make_mesh
from asr_dfcnn_transformer_tpu.train import E2ETrainer as JaxE2ETrainer
from asr_dfcnn_transformer_torch.convert import (e2e_state_dict,
                                                 flax_to_state_dict)
from asr_dfcnn_transformer_torch.core import constants
from asr_dfcnn_transformer_torch.data import AMBatch
from asr_dfcnn_transformer_torch.models import (SpeechTransformer,
                                                SpeechTransformerConfig,
                                                e2e_loss)
from asr_dfcnn_transformer_torch.train import E2ETrainer
from tests._torch_cpu import use_two_threads

use_two_threads()

KW = dict(vocab_size=30, d_model=16, num_heads=2, num_enc_blocks=1,
          num_dec_blocks=1, prenet_channels=4, position_max_length=32)
FEATS = 16            # mel filters; LFR rows of 4 x 16
BUCKET = 48           # frames: 16 LFR rows, 4 after the pre-net
LR = 3e-4


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb(tree, seed):
    """Random BatchNorm scales, biases and statistics and LayerNorm
    parameters (init leaves them at 1 / 0 / 0 / 1, which would hide a
    misnamed leaf)."""
    rng = np.random.default_rng(seed)
    out = _np(tree)

    def walk(t):
        for key, val in t.items():
            if isinstance(val, dict):
                walk(val)
            elif key == "var":
                t[key] = rng.uniform(0.5, 2.0, val.shape).astype(np.float32)
            elif key in ("mean", "bias"):
                t[key] = (0.1 * rng.standard_normal(val.shape)
                          ).astype(np.float32)
            elif key == "scale":
                t[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
    walk(out)
    return out


def _grab_tx():
    """An optimizer that leaves the parameters alone and keeps the step's
    gradients in its state."""
    return optax.GradientTransformation(
        init=lambda p: {"g": jax.tree.map(jnp.zeros_like, p)},
        update=lambda g, s, p=None: (jax.tree.map(jnp.zeros_like, g),
                                     {"g": g}))


def _arrays(seed=0, vocab=KW["vocab_size"]):
    """Three tone-and-noise utterances (the first fills the bucket), hanzi
    labels of 5, 2 and 0 tokens padded to 5, the last row back-filled."""
    rng = np.random.default_rng(seed)
    n = (BUCKET - 1) * 160 + 400
    lens = np.array([n, 5200, 3100], np.int32)
    t = np.arange(n) / 16000.0
    sig = np.zeros((3, n), np.float32)
    for i, m in enumerate(lens):
        sig[i, :m] = (0.3 * np.sin(2 * np.pi * rng.uniform(150, 400)
                                   * t[:m])
                      + 0.05 * rng.standard_normal(m))
    frames = (1 + np.ceil((lens - 400) / 160)).astype(np.int32)
    hz_len = np.array([5, 2, 0], np.int32)
    hanzi = np.zeros((3, 5), np.int32)
    for i, m in enumerate(hz_len):
        hanzi[i, :m] = rng.integers(3, vocab, m)
    weights = np.array([1, 1, 0], np.float32)
    return dict(signals=sig, signal_lengths=lens, frame_lengths=frames,
                pinyin=hanzi.copy(), pinyin_lengths=hz_len.copy(),
                hanzi=hanzi, hanzi_lengths=hz_len, weights=weights,
                bucket_frames=BUCKET)


def _config(**over):
    return SpeechTransformerConfig(**{**KW, "dropout_rate": 0.0, **over},
                                   dtype=torch.float32)


def _model(seed=0, **over):
    return SpeechTransformer(_config(**over), feature_dim=4 * FEATS,
                             device="cpu",
                             generator=torch.Generator().manual_seed(seed))


def _jax_model(backend, **over):
    return jm.SpeechTransformer(**{**KW, "dropout_rate": 0.0, **over},
                                prenet_fused=backend,
                                fused_attention=backend, dtype=jnp.float32)


def test_train_step_matches_jax(tmp_path, monkeypatch):
    arrays = _arrays()
    jbatch = JaxAMBatch(**arrays)
    feats, valid = jax_fbank(jnp.asarray(arrays["signals"]),
                             jnp.asarray(arrays["signal_lengths"]),
                             cfg=JaxFbankConfig(nfilt=FEATS),
                             out_frames=BUCKET)
    lfr, lfr_valid = jax_lfr(feats, valid, 4, 3)
    jtr = JaxE2ETrainer(_jax_model("pallas"), str(tmp_path / "jax"), lr=LR,
                        feature_dim=FEATS,
                        mesh=make_mesh(1, 1, jax.devices()[:1]))
    jtr.tx = _grab_tx()
    # the einsum model has the same variables; one jitted init is faster
    # than an eager one, which compiles each initializer on its own
    dec_in, _ = jtr.make_decoder_io(arrays["hanzi"], arrays["hanzi_lengths"])
    variables = _perturb(jax.jit(_jax_model("einsum").init)(
        jax.random.PRNGKey(0), lfr[..., None], lfr_valid,
        jnp.asarray(dec_in)), seed=1)
    jtr.state = jtr._make_state(jax.tree.map(jnp.asarray, variables))
    want = jtr.train_step(jbatch, jax.random.PRNGKey(1))

    lfr = torch.from_numpy(np.array(lfr))[..., None]
    lfr_valid = torch.from_numpy(np.array(lfr_valid))
    model = _model()
    model.load_state_dict(e2e_state_dict(variables), strict=True)
    tr = E2ETrainer(model, str(tmp_path / "port"), lr=LR, feature_dim=FEATS)
    monkeypatch.setattr(tr, "features", lambda *a: (lfr, lfr_valid))
    got = tr.train_step(AMBatch(**arrays))

    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(got["acc"]), float(want["acc"]),
                               rtol=1e-6)
    np.testing.assert_allclose(got["lr"], float(want["lr"]), rtol=1e-6)
    # rtol 1e-4, atol 1e-5 against gradient entries up to ~1: f32 sums in
    # another order through the pre-net's train-mode BatchNorms and the
    # attention VJPs
    grads = flax_to_state_dict({"params": _np(jtr.state.opt_state["g"])})
    params = dict(model.named_parameters())
    assert set(params) == set(grads)
    for name, p in params.items():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    stats = flax_to_state_dict({"batch_stats": _np(jtr.state.batch_stats)})
    buffers = dict(model.named_buffers())
    assert set(stats) == set(buffers) and len(stats) == 4
    for name, want_stat in stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), want_stat.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert tr.step == 1


@pytest.mark.parametrize("lengths", [[5, 2, 0], [0, 0, 0], [5, 5, 5]])
def test_make_decoder_io_matches_jax(lengths):
    rng = np.random.default_rng(2)
    hanzi = np.zeros((3, 5), np.int32)
    for i, m in enumerate(lengths):
        hanzi[i, :m] = rng.integers(3, 30, m)
    lens = np.array(lengths, np.int32)
    want = JaxE2ETrainer.make_decoder_io(None, hanzi, lens)
    got = E2ETrainer.make_decoder_io(hanzi, lens)
    for g, w in zip(got, want):
        assert g.dtype == np.int32
        np.testing.assert_array_equal(g, w)
    assert (got[0][:, 0] == constants.SOS).all()
    for i, n in enumerate(lengths):
        assert got[1][i, n] == constants.EOS
        assert (got[1][i, n + 1:] == constants.IGNORE_ID).all()


@pytest.mark.parametrize("case", ["mixed", "all_ignored", "none_ignored"])
def test_e2e_loss_matches_jax(case):
    rng = np.random.default_rng(3)
    logits = (3.0 * rng.standard_normal((4, 7, 30))).astype(np.float32)
    targets = rng.integers(0, 30, (4, 7)).astype(np.int32)
    targets[0, :3] = np.argmax(logits[0, :3], -1)       # a few hits
    if case == "mixed":
        targets[1, 4:] = constants.IGNORE_ID
        targets[3] = constants.IGNORE_ID
    elif case == "all_ignored":
        targets[:] = constants.IGNORE_ID
    want = jax_e2e_loss(jnp.asarray(logits), jnp.asarray(targets))
    got = e2e_loss(torch.from_numpy(logits), torch.from_numpy(targets))
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6, atol=1e-7)


def test_eval_step_drops_backfilled_rows(tmp_path):
    """Weight-0 rows' targets become IGNORE_ID: ``weight`` counts the 5 + 1
    and 2 + 1 targets of the two real rows, and the metrics equal those of
    the batch without the third row."""
    tr = E2ETrainer(_model(), str(tmp_path), feature_dim=FEATS)
    arrays = _arrays()
    ev = tr.eval_step(AMBatch(**arrays))
    assert set(ev) == {"loss", "acc", "weight"} and int(ev["weight"]) == 9
    two = {k: (v[:2] if isinstance(v, np.ndarray) else v)
           for k, v in arrays.items()}
    ev2 = tr.eval_step(AMBatch(**two))
    # the BatchNorms run on running statistics in eval: rows independent
    np.testing.assert_allclose(float(ev["loss"]), float(ev2["loss"]),
                               rtol=1e-5)
    assert float(ev["acc"]) == float(ev2["acc"])


def test_dropout_and_specaugment_step_is_seeded(tmp_path):
    """Dropout 0.1 at all seven sites and SpecAugment: the same generator
    seed gives the same loss, another seed another one."""
    arrays = _arrays(1)

    def step(seed):
        tr = E2ETrainer(_model(5, dropout_rate=0.1),
                        str(tmp_path / str(seed)), feature_dim=FEATS,
                        augment_spec=True)
        out = tr.train_step(AMBatch(**arrays),
                            torch.Generator().manual_seed(seed))
        return float(out["loss"])

    a, b, c = step(1), step(1), step(2)
    assert np.isfinite(a) and a == b and a != c


def test_fit_checkpoints_marker_resume_and_gate(tmp_path):
    train = [AMBatch(**_arrays(s)) for s in (0, 1)]
    dev = [AMBatch(**_arrays(2))]
    workdir = str(tmp_path / "e2e")
    marker = os.path.join(workdir, "e2e_epochs_completed.json")
    tr = E2ETrainer(_model(), workdir, lr=1e-3, feature_dim=FEATS)
    assert tr.restore_or_init() == 0
    out = tr.fit(lambda: iter(train), epochs=2, ckpt_every=3,
                 dev_batches=lambda: iter(dev))
    # steps 1-4: the cadence saves 3, each epoch's end 2 and 4
    assert tr.step == 4 and tr.ckpt.steps() == [2, 3, 4]
    assert out["epoch"] == 1 and np.isfinite(out["dev_loss"])
    with open(marker) as f:
        assert json.load(f) == {"epochs_completed": 2}
    assert tr.ckpt.best_metric() is not None
    assert tr.ckpt.best_metric() >= out["dev_acc"] - 1e-12

    # a new trainer resumes the step and the weights, and runs epoch 2 only
    tr2 = E2ETrainer(_model(seed=9), workdir, lr=1e-3, feature_dim=FEATS)
    assert tr2.restore_or_init() == 4
    for (name, a), b in zip(tr.model.state_dict().items(),
                            tr2.model.state_dict().values()):
        assert torch.equal(a, b), name
    tr2.save_best(metric=2.0)              # no accuracy beats it
    out2 = tr2.fit(lambda: iter(train), epochs=3, ckpt_every=3,
                   dev_batches=lambda: iter(dev))
    assert out2["epoch"] == 2 and tr2.step == 6
    assert tr2.ckpt.steps() == [2, 3, 4, 6]
    assert tr2.ckpt.best_metric() == 2.0
    with open(marker) as f:
        assert json.load(f) == {"epochs_completed": 3}
    assert os.path.exists(os.path.join(workdir, "e2e_metrics.jsonl"))

    # a marker without a checkpoint is not resumed from
    fresh = str(tmp_path / "fresh")
    os.makedirs(fresh)
    with open(os.path.join(fresh, "e2e_epochs_completed.json"), "w") as f:
        json.dump({"epochs_completed": 5}, f)
    tr3 = E2ETrainer(_model(), fresh, feature_dim=FEATS)
    out3 = tr3.fit(lambda: iter(train[:1]), epochs=1)
    assert out3["epoch"] == 0 and tr3.step == 1
