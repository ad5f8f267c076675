"""The port's training path against the JAX package's trainers.

One ``AMTrainer`` step and one ``LMTrainer`` step at f32 and small widths,
dropout 0, on Flax weights bridged by convert.py: the loss, every
parameter's gradient and the updated BatchNorm statistics. The JAX
trainers run their own jitted step; their optimizer is swapped for one that
hands the gradients back in its state, so gradients are compared directly
(Adam's first step is sign(g)-like and would hide them). Adam and the
schedule are compared separately, over three steps on the same gradients.
Then the port's epoch loop: checkpoints, resume and the best-model gate.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from asr_dfcnn_transformer_tpu.audio import batched_fbank as jax_fbank
from asr_dfcnn_transformer_tpu.audio.fbank import FbankConfig as JaxFbankConfig
from asr_dfcnn_transformer_tpu.data.loader import AMBatch as JaxAMBatch
from asr_dfcnn_transformer_tpu.data.loader import LMBatch as JaxLMBatch
from asr_dfcnn_transformer_tpu.models import SEDFCNN as JaxSEDFCNN
from asr_dfcnn_transformer_tpu.models import TransformerLM as JaxLM
from asr_dfcnn_transformer_tpu.parallel import make_mesh
from asr_dfcnn_transformer_tpu.train import AMTrainer as JaxAMTrainer
from asr_dfcnn_transformer_tpu.train import LMTrainer as JaxLMTrainer
from asr_dfcnn_transformer_tpu.train import (
    polynomial_decay_with_cycle as jax_schedule,
)
from asr_dfcnn_transformer_torch.convert import (am_state_dict,
                                                 flax_to_state_dict,
                                                 lm_state_dict)
from asr_dfcnn_transformer_torch.data import AMBatch, LMBatch
from asr_dfcnn_transformer_torch.models import (SEDFCNN, SEDFCNNConfig,
                                                TransformerLM,
                                                TransformerLMConfig)
from asr_dfcnn_transformer_torch.train import (AMTrainer, CheckpointManager,
                                               LMTrainer,
                                               polynomial_decay_with_cycle)
from tests._torch_cpu import use_two_threads

use_two_threads()

AM_KW = dict(vocab_size=24, stage_features=(4, 4, 8, 8, 8),
             se_ratio=(1, 2, 2, 2, 2), head_features=8, dropout_rate=0.0)
LM_KW = dict(d_model=32, num_heads=4, num_blocks=2, dropout_rate=0.0)
BUCKET = 64
FEATS = 40          # mel filters: a narrow front end keeps the test small


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _perturb(tree, seed):
    """Random BatchNorm scales, biases and statistics (init leaves them at
    1 / 0 / 0 / 1, which would hide a misnamed leaf)."""
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


def _am_arrays(seed=0, batch=4):
    rng = np.random.default_rng(seed)
    n = (BUCKET - 1) * 160 + 400
    lens = np.array([n, 9000, 7000, 4000, 8000, 6000][:batch], np.int32)
    t = np.arange(n) / 16000.0
    sig = np.zeros((batch, n), np.float32)
    for i, m in enumerate(lens):
        f0 = rng.uniform(150, 400)
        sig[i, :m] = (0.3 * np.sin(2 * np.pi * f0 * t[:m])
                      + 0.01 * rng.standard_normal(m))
    frames = (1 + np.ceil((lens - 400) / 160)).astype(np.int32)
    pinyin = np.zeros((batch, 4), np.int32)
    pny_len = np.array([3, 2, 1, 2, 4, 1][:batch], np.int32)
    for i, m in enumerate(pny_len):
        pinyin[i, :m] = rng.integers(1, AM_KW["vocab_size"] - 1, m)
    weights = np.ones(batch, np.float32)
    weights[-1] = 0.0                                # a back-filled row
    return dict(signals=sig, signal_lengths=lens, frame_lengths=frames,
                pinyin=pinyin, pinyin_lengths=pny_len, hanzi=pinyin.copy(),
                hanzi_lengths=pny_len.copy(), weights=weights,
                bucket_frames=BUCKET)


def _lm_arrays(seed=0):
    rng = np.random.default_rng(seed)
    lens = np.array([8, 5, 3, 6], np.int32)
    pinyin = np.zeros((4, 8), np.int32)
    hanzi = np.zeros((4, 8), np.int32)
    for i, m in enumerate(lens):
        pinyin[i, :m] = rng.integers(1, 32, m)
        hanzi[i, :m] = rng.integers(1, 48, m)
    weights = np.array([1, 1, 0, 1], np.float32)
    return dict(pinyin=pinyin, hanzi=hanzi, lengths=lens, weights=weights)


def _assert_grads(model, jax_grads, atol):
    want = flax_to_state_dict({"params": _np(jax_grads)})
    names = dict(model.named_parameters())
    assert set(names) == set(want)
    for name, p in names.items():
        assert p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   rtol=1e-4, atol=atol, err_msg=name)


def test_am_train_step_matches_jax(tmp_path, monkeypatch):
    arrays = _am_arrays()
    jbatch = JaxAMBatch(**arrays)
    flax_am = JaxSEDFCNN(dtype=jnp.float32, **AM_KW)
    jtr = JaxAMTrainer(flax_am, str(tmp_path / "jax"), lr=7e-4,
                       feature_dim=FEATS,
                       mesh=make_mesh(1, 1, jax.devices()[:1]))
    jtr.tx = _grab_tx()
    state = jtr.init_state(jax.random.PRNGKey(0), jbatch)
    variables = _perturb({"params": state.params,
                          "batch_stats": state.batch_stats}, seed=1)
    jtr.state = state.replace(
        params=jax.tree.map(jnp.asarray, variables["params"]),
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]))
    want = jtr.train_step(jbatch, jax.random.PRNGKey(1))

    # both steps see the same features: the port's fbank is held to the
    # JAX one separately (test_torch_fbank.py), to 2e-4
    feats, _ = jax_fbank(jnp.asarray(arrays["signals"]),
                             jnp.asarray(arrays["signal_lengths"]),
                             cfg=JaxFbankConfig(nfilt=FEATS),
                             out_frames=BUCKET)
    am = SEDFCNN(SEDFCNNConfig(dtype=torch.float32, **AM_KW),
                 feature_dim=FEATS, device="cpu")
    am.load_state_dict(am_state_dict(variables), strict=True)
    tr = AMTrainer(am, str(tmp_path / "port"), lr=7e-4, feature_dim=FEATS)
    monkeypatch.setattr(tr, "features", lambda *a: torch.from_numpy(
        np.array(feats))[:, None])
    got = tr.train_step(AMBatch(**arrays))

    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(got["lr"], float(want["lr"]), rtol=1e-6)
    # atol 2e-5 against gradient entries up to ~10: f32 sums taken in
    # another order through eleven train-mode BatchNorms leave differences
    # up to ~1.5e-5 (2e-6 of the largest entry) in small, cancelled entries
    _assert_grads(am, jtr.state.opt_state["g"], atol=2e-5)
    stats = flax_to_state_dict({"batch_stats": _np(jtr.state.batch_stats)})
    buffers = dict(am.named_buffers())
    assert set(stats) == set(buffers)
    for name, want_stat in stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), want_stat.numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    assert tr.step == 1


def test_lm_train_step_matches_jax(tmp_path):
    """The JAX LM runs its interpreted Pallas attention kernel and that
    kernel's custom VJP; the port runs its MaskedAttention Function."""
    arrays = _lm_arrays()
    jbatch = JaxLMBatch(**arrays)
    flax_lm = JaxLM(32, 48, fused_attention="pallas", dtype=jnp.float32,
                    **LM_KW)
    jtr = JaxLMTrainer(flax_lm, str(tmp_path / "jax"), lr=5e-5,
                       mesh=make_mesh(1, 1, jax.devices()[:1]))
    jtr.tx = _grab_tx()
    state = jtr.init_state(jax.random.PRNGKey(2), jbatch)
    params = _perturb({"params": state.params}, seed=3)["params"]
    jtr.state = state.replace(params=jax.tree.map(jnp.asarray, params))
    want = jtr.train_step(jbatch, jax.random.PRNGKey(4))

    lm = TransformerLM(TransformerLMConfig(32, 48, dtype=torch.float32,
                                           **LM_KW), device="cpu")
    lm.load_state_dict(lm_state_dict({"params": params}), strict=True)
    tr = LMTrainer(lm, str(tmp_path / "port"), lr=5e-5)
    got = tr.train_step(LMBatch(**arrays))

    for key in ("loss", "acc"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(got["lr"], float(want["lr"]), rtol=1e-6)
    _assert_grads(lm, jtr.state.opt_state["g"], atol=1e-6)


def test_adam_and_schedule_match_optax(tmp_path):
    """Three updates from the same gradients: the port's Adam at
    ``schedule(step)`` against optax.adam(polynomial_decay_with_cycle),
    with a decay horizon short enough that the rate changes every step."""
    flax_lm = JaxLM(16, 20, d_model=16, num_heads=2, num_blocks=1,
                    dtype=jnp.float32)
    params = _np(flax_lm.init(jax.random.PRNGKey(5),
                              jnp.zeros((1, 4), jnp.int32))["params"])
    rng = np.random.default_rng(6)
    grads = [jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(
        np.float32) * 1e-2, params) for _ in range(3)]

    tx = optax.adam(jax_schedule(1e-3, 2, 1e-6))
    opt_state = tx.init(params)
    want = jax.tree.map(jnp.asarray, params)
    for g in grads:
        updates, opt_state = tx.update(g, opt_state, want)
        want = optax.apply_updates(want, updates)

    lm = TransformerLM(TransformerLMConfig(16, 20, d_model=16, num_heads=2,
                                           num_blocks=1, dtype=torch.float32),
                       device="cpu")
    lm.load_state_dict(lm_state_dict({"params": params}), strict=True)
    tr = LMTrainer(lm, str(tmp_path), lr=1e-3, decay_steps=2, min_lr=1e-6)
    lrs = []
    for g in grads:
        sd = flax_to_state_dict({"params": g})
        for name, p in lm.named_parameters():
            p.grad = sd[name].clone()
        lrs.append(tr.apply_gradients())
    want_sd = flax_to_state_dict({"params": _np(want)})
    for name, p in lm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want_sd[name].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=name)
    sched = jax_schedule(1e-3, 2, 1e-6)
    np.testing.assert_allclose(lrs, [float(sched(s)) for s in range(3)],
                               rtol=1e-6)


@pytest.mark.parametrize("cycle", [True, False])
def test_schedule_matches_jax(cycle):
    want = jax_schedule(7e-4, 50, 1e-6, cycle=cycle)
    got = polynomial_decay_with_cycle(7e-4, 50, 1e-6, cycle=cycle)
    for step in (0, 1, 37, 50, 51, 120):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6,
                                   err_msg=str(step))


def test_lm_dropout_step_runs_and_is_seeded(tmp_path):
    """Dropout 0.5 (embeddings and attention probabilities through the keep
    mask): a step is finite, a seeded generator repeats it, and it differs
    from the step without dropout."""
    arrays = _lm_arrays(1)

    def step(rate, seed):
        lm = TransformerLM(TransformerLMConfig(
            32, 48, d_model=32, num_heads=4, num_blocks=2, dropout_rate=rate,
            dtype=torch.float32), device="cpu",
            generator=torch.Generator().manual_seed(7))
        tr = LMTrainer(lm, str(tmp_path / f"{rate}_{seed}"))
        gen = torch.Generator().manual_seed(seed)
        return float(tr.train_step(LMBatch(**arrays), gen)["loss"])

    a, b, c = step(0.5, 1), step(0.5, 1), step(0.0, 1)
    assert np.isfinite(a) and a == b and a != c


def _tiny_am(seed=0):
    kw = dict(AM_KW, vocab_size=24)
    return SEDFCNN(SEDFCNNConfig(dtype=torch.float32, **kw), feature_dim=200,
                   device="cpu", generator=torch.Generator().manual_seed(seed))


def test_am_fit_saves_resumes_and_gates_best(tmp_path):
    train = [AMBatch(**_am_arrays(s)) for s in (0, 1)]
    dev = [AMBatch(**_am_arrays(2))]
    workdir = str(tmp_path / "am")
    tr = AMTrainer(_tiny_am(), workdir, lr=3e-4)
    assert tr.restore_or_init() == 0
    out = tr.fit(lambda: iter(train), lambda: iter(dev), epochs=2)
    assert out["epoch"] == 1 and np.isfinite(out["dev_loss"])
    assert tr.ckpt.latest_step() == 1 and tr.step == 4
    best = tr.ckpt.best_metric()
    assert best is not None and best <= out["dev_wer"]
    ev = tr.eval_step(dev[0])
    assert set(ev) == {"loss", "ler", "weight"} and float(ev["weight"]) == 3

    # a new trainer resumes the model, the optimizer and the step
    tr2 = AMTrainer(_tiny_am(seed=9), workdir, lr=3e-4)
    assert tr2.restore_or_init() == 4
    for (name, a), b in zip(tr.model.state_dict().items(),
                            tr2.model.state_dict().values()):
        assert torch.equal(a, b), name
    # the gate starts from the persisted best: an unbeatable one is kept
    tr2.save_best(metric=-1.0)
    out2 = tr2.fit(lambda: iter(train), lambda: iter(dev), epochs=3)
    assert out2["epoch"] == 2 and tr2.step == 6
    assert tr2.ckpt.best_metric() == -1.0
    assert os.path.exists(os.path.join(workdir, "am_metrics.jsonl"))


def test_lm_fit_gates_on_accuracy(tmp_path):
    batches = [LMBatch(**_lm_arrays(s)) for s in (0, 1)]
    lm = TransformerLM(TransformerLMConfig(32, 48, dtype=torch.float32,
                                           **LM_KW), device="cpu")
    tr = LMTrainer(lm, str(tmp_path), lr=3e-3)
    out = tr.fit(lambda: iter(batches), lambda: iter(batches[:1]), epochs=2)
    assert out["epoch"] == 1
    assert tr.ckpt.best_metric() >= out["dev_acc"] - 1e-12
    ev = tr.eval_step(batches[0])
    assert float(ev["weight"]) == 8 + 5 + 6       # the weight-0 row drops


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "ck"), max_to_keep=2)
    assert mgr.latest_step() is None and mgr.restore_latest() is None
    for step in range(4):
        mgr.save(step, {"step": step, "w": torch.full((2,), float(step))})
    assert mgr.steps() == [2, 3] and mgr.latest_step() == 3
    assert mgr.restore_latest()["step"] == 3
    assert mgr.best_metric() is None and mgr.restore_best() is None
    mgr.save_best({"step": 3}, metric=0.25)
    assert mgr.best_metric() == 0.25 and mgr.restore_best() == {"step": 3}


def test_nan_guard_aborts_after_the_limit(tmp_path):
    tr = LMTrainer(TransformerLM(TransformerLMConfig(8, 8, d_model=8,
                                                     num_heads=2,
                                                     num_blocks=1),
                                 device="cpu"),
                   str(tmp_path))
    for _ in range(4):
        tr.nan_guard(float("nan"))
    tr.nan_guard(1.0)                                 # a finite loss resets
    for _ in range(4):
        tr.nan_guard(float("inf"))
    with pytest.raises(RuntimeError, match="non-finite"):
        tr.nan_guard(float("nan"))
