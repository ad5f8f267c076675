"""The port's ``dual_axis_attention`` twin against the JAX package's Pallas
kernel (interpret mode on the CPU) and against the JAX einsum attention of
``MultiHeadAttention``, with weights shared through convert.py; and the
attention routing of the port's ``MultiHeadAttention``.

The CUDA kernel is held against the twin on the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu.models.layers import (
    MultiHeadAttention as JaxMHA,
)
from asr_dfcnn_transformer_tpu.ops.pallas.attn_kernel import (
    dual_axis_attention as jax_dual_axis_attention,
)
from asr_dfcnn_transformer_torch.convert import flax_to_state_dict
from asr_dfcnn_transformer_torch.kernels import (dual_axis_attention,
                                                 dual_axis_attention_reference)
from asr_dfcnn_transformer_torch.models import layers

torch.set_num_threads(2)

_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(seed, r, t, c):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((r, t, c)).astype(np.float32)
                 for _ in range(3))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,t,c", [
    (13, 134, 64),    # time rows at bucket 1600 (prenet_masked=False)
    (11, 80, 64),     # frequency rows (LFR 320 -> 80)
    (40, 20, 64),     # short rows: the TPU kernel packs 4 per slot
    (3, 7, 32),       # tiny everything
])
def test_twin_matches_pallas_interpret(r, t, c, dtype):
    jdt, tdt, tol = _DTYPES[dtype]
    q, k, v = _qkv(0, r, t, c)
    want = jax_dual_axis_attention(*(jnp.asarray(x, jdt) for x in (q, k, v)),
                                   interpret=True)
    got = dual_axis_attention(*(torch.from_numpy(x).to(tdt)
                                for x in (q, k, v)))
    assert got.shape == (r, t, c) and got.dtype == tdt
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


@pytest.mark.parametrize("fused", ["einsum", "pallas"])
def test_single_head_mha_matches_jax(fused):
    """The port's 1-head MultiHeadAttention (routed to dual_axis_attention)
    against the JAX module's einsum and Pallas paths on shared weights."""
    rng = np.random.default_rng(1)
    r, t, d = 6, 20, 16
    x = rng.standard_normal((r, t, d)).astype(np.float32)
    jmha = JaxMHA(d, 1, fused=fused, dtype=jnp.float32)
    variables = jmha.init(jax.random.PRNGKey(0), x, x)
    want = np.asarray(jmha.apply(variables, x, x))
    mha = layers.MultiHeadAttention(d, 1, dtype=torch.float32, device="cpu",
                                    generator=torch.Generator().manual_seed(0))
    mha.load_state_dict(flax_to_state_dict(jax.tree.map(np.asarray,
                                                        variables)),
                        strict=True)
    with torch.no_grad():
        got = mha(torch.from_numpy(x), torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_wrapper_raises_on_requires_grad():
    q, k, v = (torch.from_numpy(x) for x in _qkv(2, 2, 5, 8))
    with pytest.raises(ValueError, match="no backward"):
        dual_axis_attention(q.clone().requires_grad_(True), k, v)
    with pytest.raises(ValueError, match="no backward"):
        dual_axis_attention(q, k, v.clone().requires_grad_(True))
    assert dual_axis_attention(q, k, v).shape == (2, 5, 8)


@pytest.mark.parametrize("shape,match", [
    ((2, 161, 8), "T <= 160"),
    ((2, 5, 130), "C <= 128"),
])
def test_wrapper_refuses_sizes_beyond_the_kernel(shape, match):
    x = torch.zeros(shape)
    with pytest.raises(ValueError, match=match):
        dual_axis_attention(x, x, x)


def test_wrapper_refuses_mixed_shapes_and_types():
    x = torch.zeros((2, 5, 8))
    with pytest.raises(ValueError, match="shape"):
        dual_axis_attention(x, x[:, :4], x)
    with pytest.raises(ValueError, match="dtype"):
        dual_axis_attention(x, x.double(), x)


def test_twin_is_plain_softmax_attention():
    """f32 scores scaled by 1/sqrt(C), softmax, P.V: the textbook formula
    in f64 agrees."""
    q, k, v = _qkv(3, 4, 9, 16)
    s = np.einsum("rtc,rsc->rts", q, k).astype(np.float64) / 4.0
    p = np.exp(s - s.max(-1, keepdims=True))
    p /= p.sum(-1, keepdims=True)
    want = np.einsum("rts,rsc->rtc", p, v)
    got = dual_axis_attention_reference(
        *(torch.from_numpy(x) for x in (q, k, v))).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("heads,masked,tk,route", [
    (1, False, 12, "dual"),       # the pre-net's frequency rows
    (1, True, 12, "masked"),      # its masked time rows
    (2, False, 12, "masked"),     # multi-head
    (1, False, 7, "masked"),      # cross-attention: Tq != Tk
])
def test_routing(monkeypatch, heads, masked, tk, route):
    calls = []

    def spy(name, fn):
        def wrapped(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return wrapped

    monkeypatch.setattr(layers, "dual_axis_attention",
                        spy("dual", layers.dual_axis_attention))
    monkeypatch.setattr(layers, "masked_attention",
                        spy("masked", layers.masked_attention))
    mha = layers.MultiHeadAttention(8, heads, dtype=torch.float32,
                                    device="cpu",
                                    generator=torch.Generator().manual_seed(0))
    q = torch.randn(2, 12, 8)
    kv = torch.randn(2, tk, 8)
    k_valid = torch.ones((2, tk), dtype=torch.bool) if masked else None
    with torch.no_grad():
        mha(q, kv, k_valid=k_valid)
    assert calls == [route]
