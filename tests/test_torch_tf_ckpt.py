"""The port's TF1 tensor_bundle reader / writer (``infer/tf_ckpt.py``) and
the inverse weight bridge (``convert.state_dict_to_flax``) against the JAX
package's: bundles identical byte for byte, each package reading the
other's, the TF1 loaders' trees leaf for leaf, models loaded from a bundle
computing the JAX models' logits, and the bridge's round trip."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu import models as jm
from asr_dfcnn_transformer_tpu.infer import tf_ckpt as jax_tf
from asr_dfcnn_transformer_torch.convert import (am_state_dict,
                                                 flax_to_state_dict,
                                                 lm_state_dict,
                                                 state_dict_to_flax)
from asr_dfcnn_transformer_torch.infer import tf_ckpt
from asr_dfcnn_transformer_torch.models import (SEDFCNN, SEDFCNNConfig,
                                                TransformerLM,
                                                TransformerLMConfig)
from tests._torch_cpu import use_two_threads

use_two_threads()

AM_KW = dict(vocab_size=40, stage_features=(4, 4, 8, 8, 8),
             se_ratio=(1, 2, 2, 2, 2), head_features=8, dropout_rate=0.0)
FEAT = 40
LM_IN, LM_OUT = 30, 50
LM_KW = dict(d_model=32, num_heads=4, num_blocks=2, dropout_rate=0.0)
TOL = dict(rtol=1e-5, atol=1e-5)


def _perturb(variables, seed):
    """Random norm scales, biases and BatchNorm statistics (init leaves
    them 1, 0, 0 and 1, which would hide a misplaced leaf)."""
    rng = np.random.default_rng(seed)

    def walk(tree):
        out = {}
        for key, val in tree.items():
            if isinstance(val, dict):
                out[key] = walk(val)
                continue
            val = np.asarray(val, np.float32)
            if key == "var":
                val = rng.uniform(0.5, 2.0, val.shape)
            elif key in ("mean", "bias"):
                val = 0.1 * rng.standard_normal(val.shape)
            elif key == "scale":
                val = rng.uniform(0.5, 1.5, val.shape)
            out[key] = np.asarray(val, np.float32)
        return out
    return walk(jax.tree.map(np.asarray, variables,
                             is_leaf=lambda x: not isinstance(x, dict)))


def _to_dicts(tree):
    if hasattr(tree, "items"):
        return {k: _to_dicts(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.fixture(scope="module")
def am():
    model = jm.SEDFCNN(dtype=jnp.float32, **AM_KW)
    v = jax.jit(model.init)(jax.random.PRNGKey(0),
                           jnp.zeros((1, 32, FEAT, 1)))
    return model, _perturb(_to_dicts(v), 1)


@pytest.fixture(scope="module")
def lm():
    model = jm.TransformerLM(LM_IN, LM_OUT, dtype=jnp.float32, **LM_KW)
    v = jax.jit(model.init)(jax.random.PRNGKey(1),
                           jnp.zeros((1, 8), jnp.int32))
    return model, _perturb(_to_dicts(v), 2)


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = np.asarray(v)
    return out


def _assert_trees_equal(got, want):
    fg, fw = _flat(got), _flat(want)
    assert set(fg) == set(fw)
    for k in fw:
        assert fg[k].dtype == fw[k].dtype, k
        np.testing.assert_array_equal(fg[k], fw[k], err_msg=str(k))


def _tensors():
    rng = np.random.default_rng(0)
    return {
        "a/f32": rng.standard_normal((3, 4)).astype(np.float32),
        "a/f64": rng.standard_normal(5),
        "b/i32": rng.integers(-9, 9, (2, 2)).astype(np.int32),
        "b/i64": np.array(7, np.int64),
        "c/bool": np.array([True, False, True]),
        "c/f16": rng.standard_normal(4).astype(np.float16),
        "c/u8": rng.integers(0, 255, 7).astype(np.uint8),
        "c/i8": rng.integers(-9, 9, 3).astype(np.int8),
        "c/i16": rng.integers(-9, 9, 3).astype(np.int16),
        "d/long": rng.standard_normal(70001).astype(np.float32),
        "global_step": np.array(0, np.int32),
    }


def _files(prefix):
    return [prefix + ".index", prefix + ".data-00000-of-00001"]


def test_bundles_identical_byte_for_byte(tmp_path):
    port, ref = str(tmp_path / "port" / "m.ckpt"), str(tmp_path / "jax" /
                                                        "m.ckpt")
    tf_ckpt.write_tf_checkpoint(port, _tensors())
    jax_tf.write_tf_checkpoint(ref, _tensors())
    for a, b in zip(_files(port), _files(ref)):
        assert open(a, "rb").read() == open(b, "rb").read(), a


def test_each_package_reads_the_others(tmp_path):
    port, ref = str(tmp_path / "port"), str(tmp_path / "jax")
    tf_ckpt.write_tf_checkpoint(port, _tensors())
    jax_tf.write_tf_checkpoint(ref, _tensors())
    for got in (jax_tf.read_tf_checkpoint(port),
                tf_ckpt.read_tf_checkpoint(ref)):
        assert set(got) == set(_tensors())
        for k, v in _tensors().items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert tf_ckpt.list_tf_checkpoint(ref) == \
        jax_tf.list_tf_checkpoint(port)


@pytest.mark.parametrize("n", [0, 1, 4, 63, 4095, 4096, 4097, 4160, 70001])
def test_crc32c_matches_jax(n):
    """The long-buffer numpy path and the byte loop give the JAX byte
    loop's CRC, with and without a start register."""
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    for crc in (0, 0x9E3779B9):
        assert tf_ckpt.crc32c(data, crc) == jax_tf.crc32c(data, crc)
    assert tf_ckpt.masked_crc32c(data) == jax_tf.masked_crc32c(data)
    assert tf_ckpt.crc32c(b"123456789") == 0xE3069283


def test_corrupt_tensor_is_refused(tmp_path):
    prefix = str(tmp_path / "m.ckpt")
    tf_ckpt.write_tf_checkpoint(prefix, _tensors())
    data = bytearray(open(_files(prefix)[1], "rb").read())
    data[-100] ^= 1                                   # inside "d/long"
    open(_files(prefix)[1], "wb").write(bytes(data))
    with pytest.raises(ValueError, match="checksum"):
        tf_ckpt.read_tf_checkpoint(prefix)


def test_tf1_loaders_give_the_jax_trees(tmp_path, am, lm):
    am_prefix, lm_prefix = str(tmp_path / "am"), str(tmp_path / "lm")
    jax_tf.write_tf_checkpoint(am_prefix, jax_tf.export_tf1_sedfcnn(am[1]))
    jax_tf.write_tf_checkpoint(lm_prefix, jax_tf.export_tf1_lm(lm[1], 2))
    _assert_trees_equal(tf_ckpt.load_tf1_sedfcnn(am_prefix, 40),
                        jax_tf.load_tf1_sedfcnn(am_prefix, 40))
    _assert_trees_equal(tf_ckpt.load_tf1_lm(lm_prefix, LM_IN, LM_OUT, 2),
                        jax_tf.load_tf1_lm(lm_prefix, LM_IN, LM_OUT, 2))
    with pytest.raises(ValueError, match="vocab"):
        tf_ckpt.load_tf1_sedfcnn(am_prefix, 41)


def test_models_from_a_bundle_give_the_jax_logits(tmp_path, am, lm):
    am_prefix, lm_prefix = str(tmp_path / "am"), str(tmp_path / "lm")
    jax_tf.write_tf_checkpoint(am_prefix, jax_tf.export_tf1_sedfcnn(am[1]))
    jax_tf.write_tf_checkpoint(lm_prefix, jax_tf.export_tf1_lm(lm[1], 2))
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((2, 48, FEAT, 1)).astype(np.float32)
    port_am = SEDFCNN(SEDFCNNConfig(dtype=torch.float32, **AM_KW),
                      feature_dim=FEAT, device="cpu").eval()
    port_am.load_state_dict(am_state_dict(tf_ckpt.load_tf1_sedfcnn(
        am_prefix, 40)))
    with torch.no_grad():
        got = port_am(torch.from_numpy(feats).permute(0, 3, 1, 2)).numpy()
    want = np.asarray(am[0].apply(am[1], feats, train=False))
    np.testing.assert_allclose(got, want, **TOL)

    ids = np.array([[3, 7, 9, 1, 0, 0], [5, 5, 2, 8, 4, 6]], np.int32)
    port_lm = TransformerLM(TransformerLMConfig(
        LM_IN, LM_OUT, dtype=torch.float32, **LM_KW), device="cpu").eval()
    port_lm.load_state_dict(lm_state_dict(tf_ckpt.load_tf1_lm(
        lm_prefix, LM_IN, LM_OUT, 2)))
    with torch.no_grad():
        got = port_lm(torch.from_numpy(ids).long()).numpy()
    want = np.asarray(lm[0].apply(lm[1], ids, train=False))
    np.testing.assert_allclose(got, want, **TOL)


def test_port_export_equals_jax_export(tmp_path, am, lm):
    """A port state_dict exported through the inverse bridge is the JAX
    package's bundle of the same variables, byte for byte."""
    for kind, v, export in (
            ("am", am[1], jax_tf.export_tf1_sedfcnn),
            ("lm", lm[1], lambda x: jax_tf.export_tf1_lm(x, 2))):
        back = state_dict_to_flax(flax_to_state_dict(v), kind)
        port_export = (tf_ckpt.export_tf1_sedfcnn(back) if kind == "am"
                       else tf_ckpt.export_tf1_lm(back, 2))
        port, ref = str(tmp_path / f"p_{kind}"), str(tmp_path / f"j_{kind}")
        tf_ckpt.write_tf_checkpoint(port, port_export)
        jax_tf.write_tf_checkpoint(ref, export(v))
        for a, b in zip(_files(port), _files(ref)):
            assert open(a, "rb").read() == open(b, "rb").read(), a


def _e2e_variables():
    model = jm.SpeechTransformer(
        vocab_size=50, d_model=32, num_heads=4, num_enc_blocks=1,
        num_dec_blocks=1, prenet_channels=8, position_max_length=64,
        prenet_fused="einsum", fused_attention="einsum", dtype=jnp.float32)
    feats = jnp.zeros((2, 22, 18, 1), jnp.float32)
    valid = jnp.array([22, 15], jnp.int32)
    dec = jnp.array([[1, 5, 6, 9], [1, 7, 2, 0]], jnp.int32)
    v = jax.jit(model.init)(jax.random.PRNGKey(0), feats, valid, dec)
    return _perturb(_to_dicts(v), 3)


@pytest.mark.parametrize("kind", ["am", "lm", "e2e"])
def test_state_dict_to_flax_inverts_the_bridge(kind, am, lm):
    v = {"am": lambda: am[1], "lm": lambda: lm[1], "e2e": _e2e_variables}[
        kind]()
    sd = flax_to_state_dict(v)
    _assert_trees_equal(state_dict_to_flax(sd, kind), v)
    other = "lm" if kind != "lm" else "am"
    with pytest.raises(ValueError, match="batch statistics"):
        state_dict_to_flax(sd, other)
    with pytest.raises(ValueError, match="kind"):
        state_dict_to_flax(sd, "nope")
    # "bigru" is a kind since the BiGRU was ported: like the LM's, its
    # state_dicts hold no batch statistics
    if kind == "lm":
        _assert_trees_equal(state_dict_to_flax(sd, "bigru"), v)
    else:
        with pytest.raises(ValueError, match="no batch statistics"):
            state_dict_to_flax(sd, "bigru")
