"""The port's ``BiGRUCTC`` against the JAX package's, both recurrences: the
default Flax ``GRUCell`` path (time-aligned backward) and the
``keras_parity`` path (Keras gates, ``go_backwards`` outputs left in
processing order), on bridged weights (convert.py); the Keras ``.hdf5``
pair both ways between the packages; the identity stamp; and one
``AMTrainer`` step against the JAX trainer's."""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu import models as jm
from asr_dfcnn_transformer_tpu.infer import hdf5_import as jh5
from asr_dfcnn_transformer_tpu.models.bigru import KerasGRU as JaxKerasGRU
from asr_dfcnn_transformer_tpu.train import identity as jax_identity
from asr_dfcnn_transformer_torch.convert import (bigru_state_dict,
                                                 flax_to_state_dict,
                                                 state_dict_to_flax)
from asr_dfcnn_transformer_torch.infer import hdf5_import as th5
from asr_dfcnn_transformer_torch.models import BiGRUCTC, BiGRUCTCConfig
from asr_dfcnn_transformer_torch.models.bigru import _run_gru_pair
from asr_dfcnn_transformer_torch.train import identity
from tests._torch_cpu import use_two_threads

use_two_threads()

B, T, F, H, VOCAB = 2, 64, 40, 32, 48


def _perturb_biases(variables, seed):
    """Numpy tree with random biases (init leaves them at zero, which
    would hide a misplaced gate bias)."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.asarray, variables)

    def walk(tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val)
            elif key == "bias":
                tree[key] = (0.3 * rng.standard_normal(val.shape)
                             ).astype(np.float32)
    walk(out)
    return out


def _inputs(seed=1):
    return np.random.default_rng(seed).standard_normal((B, T, F)).astype(
        np.float32)


def _flax(keras_parity, num_layers, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return jm.BiGRUCTC(VOCAB, hidden=H, num_layers=num_layers,
                       dropout_rate=0.0, keras_parity=keras_parity,
                       dtype=jdt)


@functools.lru_cache(maxsize=None)
def _variables(keras_parity, num_layers, seed):
    """Perturbed Flax variables, once a module for each layout (the
    parameters are f32 in either dtype); the init jitted."""
    flax_am = _flax(keras_parity, num_layers, torch.float32)
    return _perturb_biases(jax.jit(flax_am.init)(
        jax.random.PRNGKey(0), jnp.asarray(_inputs())), seed)


def _pair(keras_parity, num_layers=2, seed=2, dtype=torch.float32):
    """(Flax module, perturbed variables, a fresh port model on those
    weights)."""
    flax_am = _flax(keras_parity, num_layers, dtype)
    variables = _variables(keras_parity, num_layers, seed)
    am = BiGRUCTC(BiGRUCTCConfig(VOCAB, hidden=H, num_layers=num_layers,
                                 dropout_rate=0.0, keras_parity=keras_parity,
                                 dtype=dtype), feature_dim=F, device="cpu")
    am.load_state_dict(bigru_state_dict(variables), strict=True)
    return flax_am, variables, am


@pytest.mark.parametrize("keras_parity", [False, True])
def test_logits_match_jax(keras_parity):
    x = _inputs()
    flax_am, variables, am = _pair(keras_parity)
    want = np.asarray(jax.jit(flax_am.apply)(variables,
                                             jnp.asarray(x)[..., None]))
    am.eval()
    with torch.no_grad():
        got = am(torch.from_numpy(x)[:, None]).numpy()   # [B, 1, T, F]
    assert got.shape == (B, T, VOCAB)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_bf16_default_path_follows_jax():
    """bf16 gates with the f32 carry: within bf16 rounding of the JAX
    model after 64 steps of two layers."""
    x = _inputs(3)
    flax_am, variables, am = _pair(False, dtype=torch.bfloat16)
    want = np.asarray(jax.jit(flax_am.apply)(variables, jnp.asarray(x)))
    am.eval()
    with torch.no_grad():
        got = am(torch.from_numpy(x)).numpy()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err < 2e-2, err


def test_keras_go_backwards_outputs_stay_in_processing_order():
    """The Keras backward layer's output k is its state after frames T-1
    .. T-1-k, not the state for frame k: it is added to the forward
    outputs as it is (cnn_rnn_ctc.py:50-53). The default path puts it back
    at frame T-1-k."""
    flax_gru = JaxKerasGRU(H, go_backwards=True, dtype=jnp.float32)
    x = np.random.default_rng(5).standard_normal((B, 8, H)).astype(
        np.float32)
    v = _perturb_biases(flax_gru.init(jax.random.PRNGKey(1),
                                      jnp.asarray(x)), 6)
    want = np.asarray(flax_gru.apply(v, jnp.asarray(x)))
    _, _, am = _pair(True, num_layers=1)
    g = am.gru_bwd_0
    p = v["params"]
    with torch.no_grad():
        g.weight.copy_(torch.tensor(p["kernel"].T))
        g.recurrent_weight.copy_(torch.tensor(p["recurrent_kernel"].T))
        g.bias.copy_(torch.tensor(p["bias"]))
        g2 = am.gru_fwd_0
        for name in ("weight", "recurrent_weight", "bias"):
            getattr(g2, name).copy_(getattr(g, name))
        xt = torch.from_numpy(x)
        got = am._keras_layer(xt, 0).numpy()
    # forward over x, plus the Keras backward outputs in processing order
    flax_fwd = JaxKerasGRU(H, dtype=jnp.float32)
    fwd = np.asarray(flax_fwd.apply(v, jnp.asarray(x)))
    np.testing.assert_allclose(got, fwd + want, rtol=1e-5, atol=1e-6)
    # output 0 of the backward layer has seen only the last frame
    one = np.asarray(flax_gru.apply(v, jnp.asarray(x[:, -1:])))
    np.testing.assert_allclose(want[:, 0], one[:, 0], rtol=1e-6, atol=1e-6)

    # the pair runner, time-aligned or not, on a step that sums its inputs
    xp = torch.arange(2 * 1 * 4 * 3, dtype=torch.float32).reshape(2, 1, 4, 3)
    step = lambda h, xk, w: h + xk[..., :1]            # noqa: E731
    w_h = torch.zeros(2, 3, 1)
    fwd_t, bwd_p = _run_gru_pair(xp, w_h, step, False, torch.float32)
    _, bwd_a = _run_gru_pair(xp, w_h, step, True, torch.float32)
    np.testing.assert_array_equal(bwd_a.numpy(), bwd_p.flip(1).numpy())
    col = xp[1, 0, :, 0]
    np.testing.assert_array_equal(bwd_p[0, :, 0].numpy(),
                                  torch.cumsum(col.flip(0), 0).numpy())


def test_hdf5_both_ways_bit_equal(tmp_path):
    """JAX writes, the port reads; the port writes, JAX reads: the same
    arrays bit for bit, and the port model on the file computes the JAX
    model's logits."""
    pytest.importorskip("h5py")
    flax_am, variables, am = _pair(True, num_layers=3)
    jpath = str(tmp_path / "jax.hdf5")
    jh5.save_keras_bigru_hdf5(jpath, variables, VOCAB, hidden=H)
    got = th5.load_keras_bigru_hdf5(jpath, VOCAB)
    want = jh5.load_keras_bigru_hdf5(jpath, VOCAB)
    assert th5.hdf5_bigru_hidden(jpath) == H
    for k, v in flax_to_state_dict(want).items():
        np.testing.assert_array_equal(flax_to_state_dict(got)[k].numpy(),
                                      v.numpy(), err_msg=k)

    ppath = str(tmp_path / "port.hdf5")
    port_vars = state_dict_to_flax(am.state_dict(), "bigru")
    th5.save_keras_bigru_hdf5(ppath, port_vars, VOCAB, hidden=H)
    back = jh5.load_keras_bigru_hdf5(ppath, VOCAB)
    sd = am.state_dict()
    for k, v in flax_to_state_dict(back).items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)

    fresh = BiGRUCTC(BiGRUCTCConfig(VOCAB, hidden=H, keras_parity=True,
                                    dropout_rate=0.0, dtype=torch.float32),
                     feature_dim=F, device="cpu")
    fresh.load_state_dict(bigru_state_dict(got), strict=True)
    fresh.eval()
    x = _inputs(4)
    with torch.no_grad():
        mine = fresh(torch.from_numpy(x)).numpy()
    theirs = np.asarray(flax_am.apply(variables, jnp.asarray(x)))
    np.testing.assert_allclose(mine, theirs, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="vocab"):
        th5.load_keras_bigru_hdf5(jpath, VOCAB + 1)


@pytest.mark.parametrize("keras_parity", [False, True])
def test_identity_stamp_matches_jax(tmp_path, keras_parity):
    flax_am = jm.BiGRUCTC(VOCAB, hidden=H, num_layers=2,
                          keras_parity=keras_parity)
    am = BiGRUCTC(BiGRUCTCConfig(VOCAB, hidden=H, num_layers=2,
                                 keras_parity=keras_parity), feature_dim=F,
                  device="cpu")
    jax_identity.write_identity(str(tmp_path / "j"), flax_am)
    identity.write_identity(str(tmp_path / "p"), am)
    with open(os.path.join(tmp_path, "j", "identity.json"), "rb") as f:
        want = f.read()
    with open(os.path.join(tmp_path, "p", "identity.json"), "rb") as f:
        assert f.read() == want
    assert json.loads(want)["class"] == "BiGRUCTC"


def test_device_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        BiGRUCTC(BiGRUCTCConfig(VOCAB, hidden=H))


@pytest.mark.parametrize("keras_parity", [False, True])
def test_am_trainer_step_matches_jax(tmp_path, monkeypatch, keras_parity):
    """The BiGRU trains through AMTrainer, as in JAX: the CTC lengths are
    ``frames // 8 + 1`` although the logits keep every frame."""
    from asr_dfcnn_transformer_tpu.data.loader import AMBatch as JaxAMBatch
    from asr_dfcnn_transformer_tpu.parallel import make_mesh
    from asr_dfcnn_transformer_tpu.train import AMTrainer as JaxAMTrainer
    from asr_dfcnn_transformer_torch.data import AMBatch
    from asr_dfcnn_transformer_torch.train import AMTrainer
    from tests.test_torch_train import BUCKET, FEATS, _am_arrays, _grab_tx

    arrays = _am_arrays()
    jbatch = JaxAMBatch(**arrays)
    flax_am = jm.BiGRUCTC(24, hidden=16, num_layers=1, dropout_rate=0.0,
                          keras_parity=keras_parity, dtype=jnp.float32)
    jtr = JaxAMTrainer(flax_am, str(tmp_path / "jax"), lr=7e-4,
                       feature_dim=FEATS,
                       mesh=make_mesh(1, 1, jax.devices()[:1]))
    jtr.tx = _grab_tx()
    feats, _ = jax.jit(jtr._features, static_argnums=2)(
        jnp.asarray(arrays["signals"]), jnp.asarray(arrays["signal_lengths"]),
        BUCKET)
    params = _perturb_biases(jax.jit(flax_am.init)(
        jax.random.PRNGKey(0), feats), 7)["params"]
    jtr.state = jtr._make_state({"params": jax.tree.map(jnp.asarray,
                                                        params)})
    want = jtr.train_step(jbatch, jax.random.PRNGKey(1))

    am = BiGRUCTC(BiGRUCTCConfig(24, hidden=16, num_layers=1,
                                 dropout_rate=0.0, keras_parity=keras_parity,
                                 dtype=torch.float32), feature_dim=FEATS,
                  device="cpu")
    am.load_state_dict(bigru_state_dict({"params": params}), strict=True)
    tr = AMTrainer(am, str(tmp_path / "port"), lr=7e-4, feature_dim=FEATS)
    monkeypatch.setattr(tr, "features", lambda *a: torch.from_numpy(
        np.array(feats)).permute(0, 3, 1, 2))
    got = tr.train_step(AMBatch(**arrays))
    np.testing.assert_allclose(float(got["loss"]), float(want["loss"]),
                               rtol=1e-5)
    grads = flax_to_state_dict({"params": jax.tree.map(
        np.asarray, jtr.state.opt_state["g"])})
    scale = max(float(g.abs().max()) for g in grads.values())
    for name, p in am.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   rtol=1e-4, atol=1e-4 * scale,
                                   err_msg=name)


def test_cli_am_eval_and_export_bigru(tmp_path, capsys):
    """``am --model bigru`` trains the JAX CLI's small BiGRU, ``eval
    --model bigru`` reads it back, and ``export --what bigru`` writes a
    keras_parity BiGRU checkpoint as the JAX reader's cnn_rnn_ctc file,
    bit for bit."""
    pytest.importorskip("h5py")
    from asr_dfcnn_transformer_torch.train import CheckpointManager, cli
    wd = str(tmp_path / "wd")
    small = ["--synthetic", "16", "--small", "--batch-size", "8",
             "--platform", "cpu", "--model", "bigru"]
    cli.main(["am", "--workdir", wd, "--epochs", "1", "--lr", "1e-3"]
             + small)
    with open(os.path.join(wd, "ckpt_am", "identity.json")) as f:
        stamp = json.load(f)
    assert stamp["class"] == "BiGRUCTC"
    assert stamp["fields"]["hidden"] == 32
    cli.main(["lm", "--workdir", wd, "--epochs", "1", "--lr", "1e-3"]
             + small[:-2])
    capsys.readouterr()
    cli.main(["eval", "--workdir", wd] + small)
    assert "拼音 word accuracy ratio" in capsys.readouterr().out
    # the default-path checkpoint has no Keras layout
    with pytest.raises(SystemExit, match="does not match the bigru/hdf5"):
        cli.main(["export", "--workdir", wd, "--what", "bigru", "--format",
                  "hdf5", "--out", str(tmp_path / "x.hdf5")])
    keras_wd = str(tmp_path / "keras")
    _, variables, am = _pair(True, num_layers=3)
    CheckpointManager(os.path.join(keras_wd, "ckpt_am")).save(
        0, {"model": am.state_dict(), "step": 0})
    out = str(tmp_path / "bigru.hdf5")
    cli.main(["export", "--workdir", keras_wd, "--what", "bigru",
              "--format", "hdf5", "--use-latest", "--out", out])
    got = flax_to_state_dict(jh5.load_keras_bigru_hdf5(out, VOCAB))
    for k, v in am.state_dict().items():
        np.testing.assert_array_equal(got[k].numpy(), v.numpy(), err_msg=k)
