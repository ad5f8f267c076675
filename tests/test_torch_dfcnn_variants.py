"""The reference's own acoustic models in the port: ``DFCNN`` (with the NIN
insert of ``ConvBnCell``) and ``KerasDFCNN`` against the Flax modules on
bridged weights (convert.py), in evaluation and training mode; the bf16
logits head against ``bf16_dot_general`` for the three AMs and the LM; the
identity stamps of the two models against the JAX package's, byte for
byte; and a JAX checkpoint of each carried into a port checkpoint."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu import models as jm
from asr_dfcnn_transformer_tpu.models.layers import bf16_dot_general
from asr_dfcnn_transformer_tpu.train import identity as jax_identity
from asr_dfcnn_transformer_torch import models as tm
from asr_dfcnn_transformer_torch.convert import (am_state_dict,
                                                 flax_checkpoint_to_port,
                                                 lm_state_dict,
                                                 state_dict_to_flax)
from asr_dfcnn_transformer_torch.models.layers import Bf16Matmul, ConvBnCell
from asr_dfcnn_transformer_torch.train import AMTrainer
from asr_dfcnn_transformer_torch.train import identity
from tests._torch_cpu import use_two_threads

use_two_threads()

B, T, F, VOCAB = 2, 64, 40, 48


def _perturb(variables, seed):
    """Numpy tree with random BatchNorm statistics, scales and biases (the
    init's mean 0, var 1, scale 1 and zero biases would hide a transposed
    or misnamed leaf)."""
    rng = np.random.default_rng(seed)
    out = jax.tree.map(np.asarray, variables)

    def walk(tree):
        for key, val in tree.items():
            if isinstance(val, dict):
                walk(val)
            elif key == "var":
                tree[key] = rng.uniform(0.5, 2.0, val.shape).astype(np.float32)
            elif key in ("mean", "bias"):
                tree[key] = (0.1 * rng.standard_normal(val.shape)
                             ).astype(np.float32)
            elif key == "scale":
                tree[key] = rng.uniform(0.5, 1.5, val.shape).astype(np.float32)
    walk(out)
    return out


def _inputs(seed=1):
    return np.random.default_rng(seed).standard_normal((B, T, F)).astype(
        np.float32)


# (JAX class, port class, port config, extra fields)
MODELS = {"dfcnn": (jm.DFCNN, tm.DFCNN, tm.DFCNNConfig, {}),
          "keras_dfcnn": (jm.KerasDFCNN, tm.KerasDFCNN, tm.KerasDFCNNConfig,
                          dict(dense_units=16))}


def _pair(name, x, dtype=torch.float32, seed=2, **over):
    """(Flax module, perturbed variables, port model on those weights)."""
    jcls, pcls, pcfg, extra = MODELS[name]
    kw = dict(extra, dropout_rate=0.0, **over)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    flax_am = jcls(VOCAB, dtype=jdt, **kw)
    variables = _perturb(flax_am.init(jax.random.PRNGKey(0),
                                      jnp.asarray(x)[..., None]), seed)
    am = pcls(pcfg(VOCAB, dtype=dtype, **kw), feature_dim=F, device="cpu")
    am.load_state_dict(am_state_dict(variables), strict=True)
    return flax_am, variables, am


@pytest.mark.parametrize("name", sorted(MODELS))
def test_variant_matches_flax_in_eval(name):
    x = _inputs()
    flax_am, variables, am = _pair(name, x)
    want = np.asarray(flax_am.apply(variables, jnp.asarray(x)[..., None]))
    am.eval()
    with torch.inference_mode():
        got = am(torch.from_numpy(x)[:, None]).numpy()
    assert got.shape == want.shape == (B, T // 8, VOCAB)
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_variant_matches_flax_in_training(name):
    """Training mode (dropout 0): batch statistics for the outputs, and
    every running statistic updated as Flax updates it."""
    x = _inputs(3)
    flax_am, variables, am = _pair(name, x, seed=4)
    want, upd = flax_am.apply(variables, jnp.asarray(x)[..., None],
                              train=True, mutable=["batch_stats"])
    am.train()
    got = am(torch.from_numpy(x)[:, None]).detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4, rtol=1e-4)
    stats = state_dict_to_flax(am.state_dict(), "am")["batch_stats"]
    want_stats = jax.tree.map(np.asarray, upd["batch_stats"])
    flat = jax.tree_util.tree_flatten_with_path(want_stats)[0]
    assert len(flat) == len(jax.tree.leaves(stats))
    for path, leaf in flat:
        node = stats
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(node, leaf, atol=1e-5, rtol=1e-5,
                                   err_msg=jax.tree_util.keystr(path))


def test_nin_cell_layout():
    """The NIN insert's names, and its 1x1 HWIO kernel bridged to OIHW."""
    x = _inputs()
    _, variables, am = _pair("dfcnn", x)
    cell = am.ConvBnCell_5
    assert isinstance(cell, ConvBnCell) and cell.nin
    k = variables["params"]["ConvBnCell_5"]["Conv_1"]["kernel"]
    assert k.shape == (1, 1, 256, 32)
    np.testing.assert_array_equal(cell.Conv_1.weight.detach().numpy(),
                                  k.transpose(3, 2, 0, 1))
    names = {n.split(".")[1] for n in am.state_dict()
             if n.startswith("ConvBnCell_5.")}
    assert names == {"Conv_0", "BatchNorm_0", "Conv_1", "BatchNorm_1",
                     "Conv_2", "BatchNorm_2"}
    assert am.Dense_0.weight.shape == (VOCAB, (F // 8) * 256)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_bf16_variant_agrees_on_tokens(name):
    """bf16 stacks (f32 heads) over 4 x 128 frames: bf16 rounds at other
    places in the two frameworks (the logits differ by ~6e-3 at most), so
    the score is the frame argmax: equal wherever Flax's top-2 margin is at
    least 0.02, and on at least 95% of all frames."""
    x = np.random.default_rng(5).standard_normal((4, 128, F)).astype(
        np.float32)
    flax_am, variables, am = _pair(name, x, dtype=torch.bfloat16, seed=6)
    want = np.asarray(flax_am.apply(variables, jnp.asarray(x)[..., None]))
    am.eval()
    with torch.inference_mode():
        got = am(torch.from_numpy(x)[:, None])
    assert got.dtype == torch.float32
    got = got.numpy()
    assert np.abs(got - want).max() < 0.02
    top2 = np.sort(want, axis=-1)[..., -2:]
    sure = top2[..., 1] - top2[..., 0] >= 0.02
    np.testing.assert_array_equal(got.argmax(-1)[sure],
                                  want.argmax(-1)[sure])
    assert np.mean(got.argmax(-1) == want.argmax(-1)) >= 0.95


def test_bf16_matmul_matches_bf16_dot_general():
    """The head's product against ``bf16_dot_general`` on the same inputs:
    the same rounded operands summed in f32 (only the order of the f32 sums
    differs), and its gradients against JAX's VJP, which rounds each
    cotangent to bf16 (one bf16 ulp apart at most)."""
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 96)).astype(np.float32)
    w = (rng.standard_normal((96, 40)) / 10).astype(np.float32)   # [in, out]
    g = rng.standard_normal((3, 5, 40)).astype(np.float32)

    def jf(a, b):
        return bf16_dot_general(a, b, (((2,), (0,)), ((), ())))

    want, vjp = jax.vjp(jf, jnp.asarray(x), jnp.asarray(w))
    gx_want, gw_want = (np.asarray(v) for v in vjp(jnp.asarray(g)))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w.T.copy()).requires_grad_()
    got = Bf16Matmul.apply(xt, wt)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-5)
    got.backward(torch.from_numpy(g))
    for t, ref in ((xt.grad.numpy(), gx_want), (wt.grad.numpy().T, gw_want)):
        assert np.allclose(t, ref, rtol=2 ** -7, atol=1e-6)
        assert np.mean(t == ref) > 0.99
    # F.linear on bf16 rounds the result too: not this function
    linear = torch.nn.functional.linear(xt.bfloat16(), wt.bfloat16())
    assert not torch.equal(linear.float(), got)


def _lm_pair(logits_matmul):
    ids = np.array([[3, 5, 9, 2, 0, 0], [7, 7, 6, 1, 4, 8]], np.int32)
    kw = dict(d_model=32, num_heads=4, num_blocks=1, dropout_rate=0.0,
              logits_matmul=logits_matmul)
    flax_lm = jm.TransformerLM(24, 40, dtype=jnp.float32, **kw)
    variables = _perturb(flax_lm.init(jax.random.PRNGKey(9),
                                      jnp.asarray(ids)), 8)
    lm = tm.TransformerLM(tm.TransformerLMConfig(24, 40, dtype=torch.float32,
                                                 **kw), device="cpu")
    lm.load_state_dict(lm_state_dict(variables), strict=True)
    want = np.asarray(flax_lm.apply(variables, jnp.asarray(ids)))
    with torch.inference_mode():
        got = lm(torch.from_numpy(ids).long()).numpy()
    return got, want


def _am_pair(name, logits_matmul):
    x = _inputs(9)
    if name == "se_dfcnn":
        kw = dict(stage_features=(4, 4, 8, 8, 8), head_features=8,
                  dropout_rate=0.0, logits_matmul=logits_matmul)
        flax_am = jm.SEDFCNN(VOCAB, dtype=jnp.float32, **kw)
        variables = _perturb(flax_am.init(jax.random.PRNGKey(0),
                                          jnp.asarray(x)[..., None]), 10)
        am = tm.SEDFCNN(tm.SEDFCNNConfig(VOCAB, dtype=torch.float32, **kw),
                        feature_dim=F, device="cpu")
        am.load_state_dict(am_state_dict(variables), strict=True)
    else:
        flax_am, variables, am = _pair(name, x, seed=10,
                                       logits_matmul=logits_matmul)
    want = np.asarray(flax_am.apply(variables, jnp.asarray(x)[..., None]))
    am.eval()
    with torch.inference_mode():
        got = am(torch.from_numpy(x)[:, None]).numpy()
    return got, want


@pytest.mark.parametrize("name", ["se_dfcnn", "dfcnn", "keras_dfcnn", "lm"])
def test_bf16_head_matches_flax(name):
    """``logits_matmul="bf16"`` in f32 models against Flax's
    ``bf16_dot_general`` head. The head rounds its input to bf16, so an f32
    activation that the two frameworks sum in another order can round to
    the neighbouring bf16 value: tolerance 2e-3 absolute (one bf16 ulp of
    the activations times the head's weights), against 1e-4 in f32. The
    bf16 head must also differ from the f32 head, which the same weights
    give within 1e-4."""
    pair = _lm_pair if name == "lm" else lambda m: _am_pair(name, m)
    got, want = pair("bf16")
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    got32, want32 = pair("f32")
    np.testing.assert_allclose(got32, want32, rtol=1e-4, atol=1e-4)
    assert np.abs(got - got32).max() > 1e-5


def test_unknown_logits_matmul_raises():
    for cfg in (tm.DFCNNConfig(8, logits_matmul="fp8"),
                tm.KerasDFCNNConfig(8, logits_matmul="fp8")):
        cls = tm.DFCNN if isinstance(cfg, tm.DFCNNConfig) else tm.KerasDFCNN
        with pytest.raises(ValueError, match="f32|bf16"):
            cls(cfg, feature_dim=F, device="cpu")
    with pytest.raises(ValueError, match="f32|bf16"):
        tm.TransformerLM(tm.TransformerLMConfig(8, 8, d_model=32, num_heads=4,
                                                num_blocks=1,
                                                logits_matmul="tf32"),
                         device="cpu")


STAMP_CASES = [
    ("dfcnn", {}), ("dfcnn", dict(logits_matmul="bf16", dropout_rate=0.1)),
    ("keras_dfcnn", {}), ("keras_dfcnn", dict(dense_units=16,
                                              dtype=torch.float32)),
]


@pytest.mark.parametrize("name,over", STAMP_CASES)
def test_identity_stamp_equals_jax_byte_for_byte(name, over, tmp_path):
    jcls, pcls, pcfg, _ = MODELS[name]
    jover = dict(over)
    if "dtype" in jover:
        jover["dtype"] = jnp.float32
    jax_identity.write_identity(str(tmp_path / "jax"), jcls(1536, **jover))
    model = pcls(pcfg(1536, **over), device="cpu")
    identity.write_identity(str(tmp_path / "port"), model)
    with open(tmp_path / "jax" / "identity.json", "rb") as a, \
            open(tmp_path / "port" / "identity.json", "rb") as b:
        assert a.read() == b.read()
    # either package checks the other's stamp; logits_matmul is advisory
    identity.check_identity(str(tmp_path / "jax"), model)
    flip = "f32" if over.get("logits_matmul") == "bf16" else "bf16"
    advisory = pcls(pcfg(1536, **dict(over, logits_matmul=flip)),
                    device="cpu")
    d = identity.diff_identity(identity.read_identity(str(tmp_path / "jax")),
                               advisory)
    assert not d["structural"] and set(d["advisory"]) == {"logits_matmul"}


def test_stamp_refuses_the_other_variant(tmp_path):
    identity.write_identity(str(tmp_path), tm.DFCNN(tm.DFCNNConfig(1536),
                                                    device="cpu"))
    with pytest.raises(identity.ModelIdentityError, match="class"):
        identity.check_identity(str(tmp_path), tm.KerasDFCNN(
            tm.KerasDFCNNConfig(1536), device="cpu"))


@pytest.mark.parametrize("name", sorted(MODELS))
def test_flax_checkpoint_to_port_carries_the_variant(name, tmp_path):
    """A JAX tree of the variant with its stamp becomes a port checkpoint
    that an ``AMTrainer`` restores (the stamp checked) to the same
    logits."""
    x = _inputs(11)
    jcls, pcls, pcfg, extra = MODELS[name]
    flax_am = jcls(VOCAB, dtype=jnp.float32, **extra)
    variables = _perturb(flax_am.init(jax.random.PRNGKey(1),
                                      jnp.asarray(x)[..., None]), 12)
    jax_identity.write_identity(str(tmp_path / "jax"), flax_am)
    ckpt = str(tmp_path / "port" / "ckpt_am")
    flax_checkpoint_to_port(dict(variables, opt_state={"mu": 0}),
                            jax_identity.read_identity(str(tmp_path / "jax")),
                            ckpt)
    am = pcls(pcfg(VOCAB, dtype=torch.float32, **extra), feature_dim=F,
              device="cpu", generator=torch.Generator().manual_seed(5))
    tr = AMTrainer(am, str(tmp_path / "port"), feature_dim=F)
    assert tr.restore_or_init() == 0
    with open(os.path.join(ckpt, "identity.json")) as f:
        assert json.load(f)["class"] == jcls.__name__
    am.eval()
    with torch.inference_mode():
        got = am(torch.from_numpy(x)[:, None]).numpy()
    want = np.asarray(flax_am.apply(variables, jnp.asarray(x)[..., None]))
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
