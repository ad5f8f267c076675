"""The port's ``AMLMJoint`` and ``JointTrainer`` against the JAX package's:
every entry of the small f32 model's output dict on bridged weights
(convert.py), with and without weight-0 rows; one train step (the four
metrics, every gradient, the BatchNorm statistics) and one eval step; the
identity stamp; the epoch loop's checkpoints and its ``lm_acc`` gate."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu.data.loader import AMBatch as JaxAMBatch
from asr_dfcnn_transformer_tpu.models import AMLMJoint as JaxJoint
from asr_dfcnn_transformer_tpu.parallel import make_mesh
from asr_dfcnn_transformer_tpu.train import JointTrainer as JaxJointTrainer
from asr_dfcnn_transformer_tpu.train import identity as jax_identity
from asr_dfcnn_transformer_torch.convert import (flax_to_state_dict,
                                                 joint_state_dict)
from asr_dfcnn_transformer_torch.data import AMBatch
from asr_dfcnn_transformer_torch.models import AMLMJoint, AMLMJointConfig
from asr_dfcnn_transformer_torch.train import JointTrainer, identity
from tests._torch_cpu import use_two_threads
from tests.test_torch_train import _am_arrays, _grab_tx, _np, _perturb

use_two_threads()

AV, LV, NFILT, T = 24, 40, 40, 64


def _model_inputs(seed=0):
    rng = np.random.default_rng(seed)
    b = 4
    feats = rng.standard_normal((b, T, NFILT)).astype(np.float32)
    frames = np.array([T, 50, 33, 20], np.int32)
    pinyin = np.zeros((b, 5), np.int32)
    pny_len = np.array([3, 2, 4, 1], np.int32)
    hanzi = np.zeros((b, 5), np.int32)
    for i, m in enumerate(pny_len):
        pinyin[i, :m] = rng.integers(1, AV - 1, m)
        hanzi[i, :m] = rng.integers(1, LV, m)
    weights = np.array([1, 1, 0, 1], np.float32)
    return feats, frames, pinyin, pny_len, hanzi, weights


@functools.lru_cache(maxsize=None)
def _flax(seed=1):
    """(Flax module, perturbed variables), once a module: the Flax init
    jitted (an eager one takes twice as long on the CPU)."""
    flax_m = JaxJoint(AV, LV, small=True, dtype=jnp.float32)
    feats, frames, pinyin, pny_len, hanzi, _ = _model_inputs()
    variables = _perturb(jax.jit(flax_m.init)(
        jax.random.PRNGKey(0), jnp.asarray(feats)[..., None],
        jnp.asarray(frames), jnp.asarray(pinyin), jnp.asarray(pny_len),
        jnp.asarray(hanzi)), seed)
    return flax_m, variables


def _pair(seed=1):
    """(Flax module, perturbed variables, a fresh port model on those
    weights)."""
    flax_m, variables = _flax(seed)
    m = AMLMJoint(AMLMJointConfig(AV, LV, small=True, dtype=torch.float32),
                  feature_dim=NFILT, device="cpu")
    m.load_state_dict(joint_state_dict(variables), strict=True)
    return flax_m, variables, m


@pytest.mark.parametrize("weighted", [False, True])
def test_outputs_match_jax(weighted):
    flax_m, variables, m = _pair()
    feats, frames, pinyin, pny_len, hanzi, weights = _model_inputs(2)
    want = jax.jit(lambda v, *a, w: flax_m.apply(v, *a, weights=w))(
        variables, jnp.asarray(feats)[..., None], jnp.asarray(frames),
        jnp.asarray(pinyin), jnp.asarray(pny_len), jnp.asarray(hanzi),
        w=jnp.asarray(weights) if weighted else None)
    m.eval()
    with torch.no_grad():
        got = m(torch.from_numpy(feats)[:, None], torch.from_numpy(frames),
                torch.from_numpy(pinyin), torch.from_numpy(pny_len),
                torch.from_numpy(hanzi).long(),
                torch.from_numpy(weights) if weighted else None)
    assert set(got) == set(want)
    np.testing.assert_array_equal(got["decoded_pinyin"].numpy(),
                                  np.asarray(want["decoded_pinyin"]))
    for key in ("loss", "am_loss", "lm_loss", "lm_acc"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(got["am_logits"].numpy(),
                               np.asarray(want["am_logits"]), rtol=1e-4,
                               atol=1e-5)


def test_decode_is_outside_autograd():
    """The loss's gradient reaches the AM only through the CTC term: the
    LM's cross entropy has no path back through the greedy decode."""
    _, _, m = _pair()
    feats, frames, pinyin, pny_len, hanzi, _ = _model_inputs(3)
    m.train()
    out = m(torch.from_numpy(feats)[:, None], torch.from_numpy(frames),
            torch.from_numpy(pinyin), torch.from_numpy(pny_len),
            torch.from_numpy(hanzi).long())
    assert not out["decoded_pinyin"].requires_grad
    am_params = [p for p in m.am.parameters()]
    g_lm = torch.autograd.grad(out["lm_loss"], am_params, allow_unused=True,
                               retain_graph=True)
    assert all(g is None for g in g_lm)
    g_all = torch.autograd.grad(out["loss"], am_params, retain_graph=True)
    g_am = torch.autograd.grad(out["am_loss"], am_params)
    for a, b in zip(g_all, g_am):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_train_and_eval_step_match_jax(tmp_path, monkeypatch):
    arrays = _am_arrays(0)
    arrays["hanzi"] = (arrays["hanzi"] * 7) % (LV - 1) + 1
    arrays["hanzi"][arrays["pinyin"] == 0] = 0
    jbatch = JaxAMBatch(**arrays)
    flax_m = JaxJoint(AV, LV, small=True, dtype=jnp.float32)
    jtr = JaxJointTrainer(flax_m, str(tmp_path / "jax"), lr=7e-4,
                          feature_dim=NFILT,
                          mesh=make_mesh(1, 1, jax.devices()[:1]))
    feats = jax.jit(jtr._features, static_argnums=2)(
        jnp.asarray(arrays["signals"]), jnp.asarray(arrays["signal_lengths"]),
        arrays["bucket_frames"])[0]
    _, variables = _flax()   # the shapes of the parameters are the batch's
    jtr.tx = _grab_tx()
    jtr._train_step = jtr._build_train_step()
    jtr.state = jtr._make_state(jax.tree.map(jnp.asarray, variables))
    want_eval = jtr.eval_step(jbatch)
    want = jtr.train_step(jbatch, jax.random.PRNGKey(1))

    m = AMLMJoint(AMLMJointConfig(AV, LV, small=True, dtype=torch.float32),
                  feature_dim=NFILT, device="cpu")
    m.load_state_dict(joint_state_dict(variables), strict=True)
    tr = JointTrainer(m, str(tmp_path / "port"), lr=7e-4, feature_dim=NFILT)
    monkeypatch.setattr(tr, "features", lambda *a: torch.from_numpy(
        np.array(feats)).permute(0, 3, 1, 2))
    got_eval = tr.eval_step(AMBatch(**arrays))
    for key in ("loss", "am_loss", "lm_loss", "lm_acc", "weight"):
        np.testing.assert_allclose(float(got_eval[key]),
                                   float(want_eval[key]), rtol=1e-5,
                                   err_msg=key)
    got = tr.train_step(AMBatch(**arrays))
    for key in ("loss", "am_loss", "lm_loss", "lm_acc"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-5, err_msg=key)
    np.testing.assert_allclose(got["lr"], float(want["lr"]), rtol=1e-6)
    grads = flax_to_state_dict({"params": _np(jtr.state.opt_state["g"])})
    params = dict(m.named_parameters())
    assert set(params) == set(grads)
    # 1e-4 relative, and 1e-4 of the largest gradient entry absolute: f32
    # sums in another order through the train-mode BatchNorms
    scale = max(float(g.abs().max()) for g in grads.values())
    for name, p in params.items():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)
    stats = flax_to_state_dict({"batch_stats": _np(jtr.state.batch_stats)})
    buffers = dict(m.named_buffers())
    assert set(stats) == set(buffers)
    for name, want_stat in stats.items():
        np.testing.assert_allclose(buffers[name].numpy(), want_stat.numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=name)


def test_fit_saves_each_epoch_and_gates_on_lm_acc(tmp_path):
    train = [AMBatch(**_am_arrays(s)) for s in (0, 1)]
    dev = [AMBatch(**_am_arrays(2))]
    _, _, m = _pair()
    tr = JointTrainer(m, str(tmp_path), lr=1e-3, feature_dim=NFILT)
    assert tr.restore_or_init() == 0
    out = tr.fit(lambda: iter(train), epochs=2, dev_batches=lambda: iter(dev))
    assert out["epoch"] == 1 and tr.step == 4
    assert set(out) == {"epoch", "loss", "lm_acc", "dev_loss", "dev_lm_acc"}
    assert tr.ckpt.latest_step() == 1
    assert tr.ckpt.best_metric() >= out["dev_lm_acc"] - 1e-12
    out2 = JointTrainer(m, str(tmp_path / "nodev"), feature_dim=NFILT).fit(
        lambda: iter(train), epochs=1)
    assert "dev_lm_acc" not in out2
    with open(os.path.join(str(tmp_path), "ckpt_joint",
                           "identity.json")) as f:
        assert json.load(f)["class"] == "AMLMJoint"


@pytest.mark.parametrize("small", [True, False])
def test_identity_stamp_matches_jax(tmp_path, small):
    flax_m = JaxJoint(1536, 6345, small=small)
    m = AMLMJoint(AMLMJointConfig(1536, 6345, small=small), device="cpu") \
        if small else None
    jax_identity.write_identity(str(tmp_path / "j"), flax_m)
    if m is None:     # the stamp needs only the config, not the weights
        m = AMLMJoint.__new__(AMLMJoint)
        torch.nn.Module.__init__(m)
        m.config = AMLMJointConfig(1536, 6345, small=False)
    identity.write_identity(str(tmp_path / "p"), m)
    assert (tmp_path / "p" / "identity.json").read_bytes() == \
        (tmp_path / "j" / "identity.json").read_bytes()


def test_cli_joint(tmp_path, capsys):
    from asr_dfcnn_transformer_torch.train import cli
    wd = str(tmp_path / "wd")
    cli.main(["joint", "--workdir", wd, "--synthetic", "16", "--small",
              "--batch-size", "8", "--epochs", "1", "--lr", "1e-3",
              "--platform", "cpu"])
    out = capsys.readouterr().out
    assert "[joint] epoch 0: dev_loss" in out
    assert "joint training done" in out
    jax_identity.write_identity(str(tmp_path / "j"),
                                JaxJoint(1536, 6345, small=True,
                                         dtype=jnp.float32))
    assert (tmp_path / "wd" / "ckpt_joint" / "identity.json").read_bytes() \
        == (tmp_path / "j" / "identity.json").read_bytes()
    with open(os.path.join(wd, "config.json")) as f:
        assert json.load(f)["am"]["lr"] == 7e-4      # the config's, as JAX
    assert os.path.exists(os.path.join(wd, "ckpt_joint", "0.pt"))
