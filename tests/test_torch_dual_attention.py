"""The port's ``dual_axis_attention`` twins, forward and backward, against
the JAX package's Pallas kernel and its custom VJP (interpret mode on the
CPU) and against the JAX einsum attention of ``MultiHeadAttention``, with
weights shared through convert.py; the ``DualAxisAttention`` Function's
gradient, its backward limit; and the attention routing of the port's
``MultiHeadAttention``.

The CUDA kernels are held against the twins on the card by chip_smoke.py.
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
from asr_dfcnn_transformer_torch.kernels import (
    dual_axis_attention, dual_axis_attention_bwd_reference,
    dual_axis_attention_reference)
from asr_dfcnn_transformer_torch.kernels import dual_attention
from asr_dfcnn_transformer_torch.models import layers
from tests._torch_cpu import use_two_threads

use_two_threads()

_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _qkv(seed, r, t, c):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((r, t, c)).astype(np.float32)
                 for _ in range(3))


SHAPES = [
    (13, 134, 64),    # time rows at bucket 1600 (prenet_masked=False)
    (11, 80, 64),     # frequency rows (LFR 320 -> 80)
    (40, 20, 64),     # short rows: the TPU kernel packs 4 per slot
    (3, 7, 32),       # tiny everything
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,t,c", SHAPES)
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("r,t,c", SHAPES)
def test_bwd_twin_matches_pallas_vjp(r, t, c, dtype):
    """The backward twin against ``jax.vjp`` of the interpreted kernel
    (``_attn_packed_bwd`` / ``_bwd_kernel``, with its block-diagonal
    packing of short rows), on an f32 cotangent that both round to the
    dtype. Tolerance: f32 1e-5; bf16 one part in 50 (dS and the outputs
    are rounded to bf16, 8 significant bits, and a different f32 sum order
    may round an element the other way)."""
    jdt, tdt, tol = _DTYPES[dtype]
    q, k, v = _qkv(4, r, t, c)
    g = np.random.default_rng(5).standard_normal((r, t, c)).astype(
        np.float32)
    _, vjp = jax.vjp(lambda *a: jax_dual_axis_attention(*a, interpret=True),
                     *(jnp.asarray(x, jdt) for x in (q, k, v)))
    want = vjp(jnp.asarray(g, jdt))
    got = dual_axis_attention_bwd_reference(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        torch.from_numpy(g))
    for name, x, y in zip(("dq", "dk", "dv"), got, want):
        assert x.shape == (r, t, c) and x.dtype == tdt
        np.testing.assert_allclose(x.float().numpy(),
                                   np.asarray(y, np.float32), atol=tol,
                                   rtol=tol, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_function_gradient_is_the_twins(dtype):
    """On CPU tensors the Function's forward is the forward twin and its
    backward the backward twin, exactly; in f32 both agree with autograd
    through textbook attention."""
    q, k, v = (torch.from_numpy(x).to(dtype).requires_grad_(True)
               for x in _qkv(6, 5, 9, 16))
    g = torch.randn(5, 9, 16, generator=torch.Generator().manual_seed(7))
    out = dual_axis_attention(q, k, v)
    assert out.requires_grad
    assert torch.equal(out, dual_axis_attention_reference(q, k, v))
    got = torch.autograd.grad(out, (q, k, v), g)
    want = dual_axis_attention_bwd_reference(q, k, v, g)
    for x, y in zip(got, want):
        assert torch.equal(x, y)
    if dtype == torch.float32:
        plain = torch.softmax(q @ k.transpose(-1, -2) / 4.0, -1) @ v
        for x, y in zip(got, torch.autograd.grad(plain, (q, k, v), g)):
            np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5,
                                       rtol=1e-5)


@pytest.mark.parametrize("t,c,dtype,fits", [
    (80, 64, torch.float32, True),      # frequency rows, f32
    (134, 64, torch.bfloat16, True),    # time rows, bf16
    (134, 64, torch.float32, False),    # time rows, f32: 294,624 bytes
    (160, 128, torch.bfloat16, False),  # the forward's largest size
])
def test_backward_limit_refuses_at_forward_time(t, c, dtype, fits):
    """A forward whose inputs require grad refuses a size whose backward
    would not fit shared memory, naming it; without grad the same size
    runs the forward."""
    assert dual_attention.supports(t, c, dtype, grad=True) == fits
    x = torch.zeros((1, t, c), dtype=dtype)
    assert dual_axis_attention(x, x, x).shape == (1, t, c)
    xg = x.clone().requires_grad_(True)
    if fits:
        dual_axis_attention(xg, x, x).float().sum().backward()
        assert xg.grad.shape == (1, t, c)
        return
    need = dual_attention.bwd_smem_bytes(t, c, dtype)
    with pytest.raises(ValueError, match=f"T={t}, C={c}.*{need} bytes"):
        dual_axis_attention(x, x, xg)
    with torch.no_grad():
        assert dual_axis_attention(xg, x, x).shape == (1, t, c)


# bytes of one backward block at the sizes chip_smoke.py phase 2 queries:
# bf16, the tensor-core layout: 16 + T (4 stride(C) + 2 stride(T)) 2, with
# stride(n) = round8(n), + 8 where round8(n) / 8 is even, unless the padded
# total exceeds 232,448 bytes (then no + 8); f32, the scalar layout: Q, dO
# [T][even C], K, V [T][even C + 1], P, dS [T][T] in f32, each rounded up to
# 16 bytes, and 8 warps of four f32 rows (2 even C + 2 T)
_BWD_SMEM = [
    (80, 64, torch.bfloat16, 74256),    # 16 + 80 (4 * 72 + 2 * 88) * 2
    (134, 64, torch.bfloat16, 150096),  # 16 + 134 (4 * 72 + 2 * 136) * 2
    (7, 32, torch.bfloat16, 2480),      # 16 + 7 (4 * 40 + 2 * 8) * 2
    (160, 128, torch.bfloat16, 266256),  # unpadded: 16 + 160 (4 * 128
                                         # + 2 * 160) * 2, still too large
    (1, 1, torch.bfloat16, 112),        # 16 + 1 (4 * 8 + 2 * 8) * 2
    (33, 7, torch.bfloat16, 7408),      # 16 + 33 (4 * 8 + 2 * 40) * 2
    (80, 64, torch.float32, 142976),
    (134, 64, torch.float32, 294624),
    (7, 32, torch.float32, 6560),
    (160, 128, torch.float32, 552192),
    (1, 1, torch.float32, 288),
    (33, 7, torch.float32, 15872),
]


@pytest.mark.parametrize("t,c,dtype,need", _BWD_SMEM)
def test_backward_shared_memory_mirror_is_pinned(t, c, dtype, need):
    """``bwd_smem_bytes`` gives each layout's size by its own formula (the
    card's query, ``asr_dual_attention_bwd_smem``, must agree: phase 2),
    and ``supports`` refuses with grad exactly the sizes above 232,448
    bytes."""
    assert dual_attention.bwd_smem_bytes(t, c, dtype) == need
    assert dual_attention.supports(t, c, dtype, grad=True) == (
        need <= dual_attention.MAX_SMEM)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_backward_limit_takes_every_size_it_took(dtype):
    """Every (T, C) the scalar kernels' layout fitted (the one both dtypes
    had before the bf16 backward moved to the tensor cores: Q and dO rows
    of even(C), K and V rows one 32-bit word longer, the P and dS tiles,
    each rounded to 16 bytes, and 8 warps of four f32 rows) is still taken
    with grad."""
    size = 2 if dtype == torch.bfloat16 else 4

    def r16(n):
        return (n + 15) // 16 * 16

    for t in range(1, dual_attention.MAX_T + 1):
        for c in range(1, dual_attention.MAX_C + 1):
            ce = (c + 1) // 2 * 2
            ks = ce + 4 // size
            old = (2 * r16(t * ce * size) + 2 * r16(t * ks * size)
                   + 2 * r16(t * t * size) + r16(8 * (2 * ce + 2 * t) * 4))
            if old <= dual_attention.MAX_SMEM:
                assert dual_attention.supports(t, c, dtype, grad=True), (t, c)


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


@pytest.fixture
def routes(monkeypatch):
    """The attention kernels ``layers.MultiHeadAttention`` calls, in order."""
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
    return calls


@pytest.mark.parametrize("heads,masked,tk,route", [
    (1, False, 12, "dual"),       # the pre-net's frequency rows
    (1, True, 12, "masked"),      # its masked time rows
    (2, False, 12, "masked"),     # multi-head
    (1, False, 7, "masked"),      # cross-attention: Tq != Tk
])
def test_routing(routes, heads, masked, tk, route):
    mha = layers.MultiHeadAttention(8, heads, dtype=torch.float32,
                                    device="cpu",
                                    generator=torch.Generator().manual_seed(0))
    q = torch.randn(2, 12, 8)
    kv = torch.randn(2, tk, 8)
    k_valid = torch.ones((2, tk), dtype=torch.bool) if masked else None
    with torch.no_grad():
        mha(q, kv, k_valid=k_valid)
    assert routes == [route]


@pytest.mark.parametrize("t,dtype,route", [
    (12, torch.float32, "dual"),
    (134, torch.bfloat16, "dual"),
    (134, torch.float32, "masked"),   # the dual backward would not fit
])
def test_training_routing(routes, t, dtype, route):
    """With a gradient to flow, the pre-net's rows take the dual kernel
    within its backward's shared-memory limit and the masked kernel beyond
    it; every parameter gets a gradient either way."""
    mha = layers.MultiHeadAttention(64, 1, dtype=dtype, device="cpu",
                                    generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, t, 64)
    mha.train()(x, x).float().sum().backward()
    assert routes == [route]
    assert all(p.grad is not None for p in mha.parameters())
