"""The port's ``fused_ffn`` (its plain twin on the CPU) and its autograd
backward, ``FeedForward(fused="pallas")``, and the LM and the e2e model with
``fused_ffn="pallas"`` against the JAX package's, whose Pallas kernel runs
under ``jit`` in interpret mode off the TPU, as tests/test_ffn_kernel.py
runs it; inputs and weights come from numpy seeds (weights bridged by
convert.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu import models as jm
from asr_dfcnn_transformer_tpu.models.layers import FeedForward as JaxFFN
from asr_dfcnn_transformer_tpu.ops.pallas.ffn_kernel import (
    fused_ffn as jax_fused_ffn,
)
from asr_dfcnn_transformer_torch.convert import (e2e_state_dict,
                                                 flax_to_state_dict,
                                                 lm_state_dict)
from asr_dfcnn_transformer_torch.kernels import ffn as ffn_kernel
from asr_dfcnn_transformer_torch.kernels import fused_ffn
from asr_dfcnn_transformer_torch.models import (SpeechTransformer,
                                                SpeechTransformerConfig,
                                                TransformerLM,
                                                TransformerLMConfig, layers)
from tests._torch_cpu import use_two_threads

use_two_threads()

JAX_DTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


def _weights(d, f, seed):
    """JAX-layout weights (W1 [D, F], W2 [F, D]) with non-zero biases."""
    rng = np.random.default_rng(seed)
    w1 = (rng.standard_normal((d, f)) / np.sqrt(d)).astype(np.float32)
    w2 = (rng.standard_normal((f, d)) / np.sqrt(f)).astype(np.float32)
    b1, b2 = (0.1 * rng.standard_normal(n).astype(np.float32)
              for n in (f, d))
    return w1, b1, w2, b2


def _port_weights(w1, b1, w2, b2):
    """The same weights in the port's Linear layout (W1 [F, D], W2 [D, F])."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in (w1.T, b1, w2.T, b2))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("shape,d", [
    ((4, 10, 64), 64),      # 3-D input, N 40
    ((256, 32), 32),        # 2-D input
    ((1, 7, 16), 16),       # tiny everything
])
def test_twin_matches_jax_fused_ffn(shape, d, dtype):
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    w = _weights(d, 4 * d, 1)
    want = jax.jit(jax_fused_ffn)(jnp.asarray(x, JAX_DTYPE[dtype]),
                                  *(jnp.asarray(a) for a in w))
    got = fused_ffn(torch.from_numpy(x).to(dtype), *_port_weights(*w))
    assert got.shape == shape and got.dtype == dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype,tol", [(torch.bfloat16, 4e-2),
                                       (torch.float32, 1e-5)])
def test_fused_ffn_grads_match_jax_vjp(dtype, tol):
    """``FusedFFN``'s backward against the JAX custom VJP
    (``_fused_ffn_bwd``), each gradient within ``tol`` of its largest
    entry."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((6, 9, 32)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)
    w = _weights(32, 128, 3)

    def loss(x, *w):
        out = jax_fused_ffn(x, *w)
        return jnp.sum(out.astype(jnp.float32) * cot)

    want = jax.jit(jax.grad(loss, argnums=tuple(range(5))))(
        jnp.asarray(x, JAX_DTYPE[dtype]), *(jnp.asarray(a) for a in w))
    xt = torch.from_numpy(x).to(dtype).requires_grad_(True)
    wt = [t.requires_grad_(True) for t in _port_weights(*w)]
    out = fused_ffn(xt, *wt)
    (out.float() * torch.from_numpy(cot)).sum().backward()
    got = [xt.grad, wt[0].grad.T, wt[1].grad, wt[2].grad.T, wt[3].grad]
    assert xt.grad.dtype == dtype and wt[0].grad.dtype == torch.float32
    for name, g, r in zip(("x", "w1", "b1", "w2", "b2"), got, want):
        r = np.asarray(r, np.float32)
        scale = max(float(np.abs(r).max()), 1e-3)
        np.testing.assert_allclose(g.float().numpy() / scale, r / scale,
                                   atol=tol, err_msg=name)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_feedforward_pallas_equals_einsum(dtype):
    """On the same weights the two backends give the same bits on the CPU,
    in evaluation and in training (dropout from equal generators): the twin
    rounds as ``Dense`` does. The parameters sit under Dense_0 / Dense_1
    either way."""
    kw = dict(dropout_rate=0.3, dtype=dtype, device="cpu")
    ffn_e = layers.FeedForward(48, fused="einsum",
                               generator=torch.Generator().manual_seed(0), **kw)
    ffn_p = layers.FeedForward(48, fused="pallas",
                               generator=torch.Generator().manual_seed(0), **kw)
    assert ffn_p.state_dict().keys() == ffn_e.state_dict().keys()
    assert ffn_p.Dense_0.weight.shape == (192, 48)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (3, 12, 48)).astype(np.float32)).to(dtype)
    with torch.no_grad():
        assert torch.equal(ffn_p.eval()(x), ffn_e.eval()(x))
        got = ffn_p.train()(x, torch.Generator().manual_seed(1))
        want = ffn_e.train()(x, torch.Generator().manual_seed(1))
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_feedforward_matches_jax(dtype):
    """The JAX ``FeedForward(fused="pallas")`` (the kernel interpreted)
    against the port's on bridged weights."""
    x = np.random.default_rng(6).standard_normal((3, 12, 48)).astype(
        np.float32)
    jffn = JaxFFN(48, fused="pallas", dtype=JAX_DTYPE[dtype])
    xj = jnp.asarray(x, JAX_DTYPE[dtype])
    variables = _np(jax.jit(jffn.init)(jax.random.PRNGKey(6), xj))
    variables["params"]["Dense_0"]["bias"] = _weights(48, 192, 7)[1]
    want = jax.jit(jffn.apply)(variables, xj)
    port = layers.FeedForward(48, fused="pallas", dtype=dtype, device="cpu",
                              generator=torch.Generator())
    port.load_state_dict(flax_to_state_dict(variables), strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).to(dtype))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
def test_transformer_lm_with_fused_ffn_matches_jax(dtype, tol):
    """d 64, 4 heads, 2 blocks, ``fused_ffn="pallas"`` on both sides (the
    attention einsum on both, so that bf16 rounds alike there); bf16 at
    tests/test_ffn_kernel.py's 5e-2."""
    ids = np.array([[3, 5, 9, 2, 0, 0, 0, 0],
                    [7, 7, 7, 7, 7, 7, 7, 6]], np.int32)
    kw = dict(d_model=64, num_heads=4, num_blocks=2, dropout_rate=0.0,
              fused_attention="einsum", fused_ffn="pallas")
    jlm = jm.TransformerLM(32, 48, dtype=JAX_DTYPE[dtype], **kw)
    variables = _np(jax.jit(jlm.init)(jax.random.PRNGKey(7),
                                      jnp.asarray(ids)))
    want = np.asarray(jax.jit(jlm.apply)(variables, jnp.asarray(ids)))
    lm = TransformerLM(TransformerLMConfig(32, 48, dtype=dtype, **kw),
                       device="cpu")
    lm.load_state_dict(lm_state_dict(variables), strict=True)
    with torch.no_grad():
        got = lm(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


def test_speech_transformer_with_fused_ffn_matches_jax():
    """The e2e encoder and the teacher-forced decoder's logits, f32,
    ``fused_ffn="pallas"`` on both sides, at tests/test_torch_e2e.py's
    widths."""
    kw = dict(vocab_size=50, d_model=32, num_heads=4, num_enc_blocks=2,
              num_dec_blocks=2, prenet_channels=8, position_max_length=64,
              dropout_rate=0.1, fused_ffn="pallas")
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((3, 22, 18, 1)).astype(np.float32)
    valid = np.array([22, 15, 7], np.int32)
    for i, n in enumerate(valid):
        feats[i, n:] = 0.0
    dec = np.array([[1, 5, 6, 9], [1, 7, 2, 0], [1, 3, 0, 0]], np.int32)
    jkw = dict(kw, prenet_fused="einsum", fused_attention="einsum",
               dtype=jnp.float32)
    jmod = jm.SpeechTransformer(**jkw)
    # the same tree from the unfused model's jitted init (an eager init
    # would interpret the kernel op by op)
    variables = _np(jax.jit(jm.SpeechTransformer(
        **dict(jkw, fused_ffn="einsum")).init)(jax.random.PRNGKey(0), feats,
                                               valid, dec))
    mem_j, _ = jax.jit(lambda v, f, m: jmod.apply(
        v, f, m, method=jm.SpeechTransformer.encode))(variables, feats, valid)
    logits_j = jax.jit(jmod.apply)(variables, feats, valid, dec)
    model = SpeechTransformer(SpeechTransformerConfig(**kw,
                                                      dtype=torch.float32),
                              feature_dim=18, device="cpu")
    model.load_state_dict(e2e_state_dict(variables), strict=True)
    model.eval()
    args = [torch.from_numpy(a) for a in (feats, valid, dec)]
    with torch.no_grad():
        mem, _ = model.encode(*args[:2])
        logits = model(*args)
    np.testing.assert_allclose(mem.numpy(), np.asarray(mem_j), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_allclose(logits.numpy(), np.asarray(logits_j),
                               atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("d,inner", [(24, 96), (528, 2112), (64, 200)])
def test_pallas_refuses_widths_the_kernel_cannot_take(d, inner):
    """Widths the kernel once refused (D above 512, D or F not a multiple
    of 16) build with "pallas" as with the unfused backends; refused, when
    the module is built and before any weight is made, are only widths
    beyond the launcher's C ints, which the JAX kernel's VMEM cannot hold
    either."""
    kw = dict(dtype=torch.float32, device="cpu", generator=torch.Generator())
    layers.FeedForward(d, inner, fused="pallas", **kw)
    layers.FeedForward(d, inner, fused="einsum", **kw)
    with pytest.raises(ValueError, match="the kernel takes 1 <= D, F <="):
        layers.FeedForward(2**31, inner, fused="pallas", **kw)


def test_wrapper_raises_off_cpu_and_cuda():
    """A tensor on neither the CPU nor CUDA (here the meta device) is
    refused, never run through the twin. Needs no JAX."""
    x = torch.empty((4, 16), device="meta")
    w1, w2 = torch.empty((64, 16), device="meta"), torch.empty(
        (16, 64), device="meta")
    b1, b2 = torch.empty(64, device="meta"), torch.empty(16, device="meta")
    with pytest.raises(ValueError, match="expected CUDA or CPU tensors"):
        fused_ffn(x, w1, b1, w2, b2)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_wide_feedforward_builds_and_matches_jax(dtype):
    """``FeedForward(1024, fused="pallas")`` (inner 4096, above the old
    512 limit) builds on the CPU and matches the JAX block with its kernel
    interpreted, on bridged weights."""
    d = 1024
    x = np.random.default_rng(8).standard_normal((2, 3, d)).astype(
        np.float32)
    jffn = JaxFFN(d, fused="pallas", dtype=JAX_DTYPE[dtype])
    xj = jnp.asarray(x, JAX_DTYPE[dtype])
    variables = _np(jax.jit(JaxFFN(d, fused="einsum",
                                   dtype=JAX_DTYPE[dtype]).init)(
        jax.random.PRNGKey(8), xj))
    variables["params"]["Dense_0"]["bias"] = _weights(d, 4 * d, 9)[1]
    want = jax.jit(jffn.apply)(variables, xj)
    port = layers.FeedForward(d, fused="pallas", dtype=dtype, device="cpu",
                              generator=torch.Generator())
    port.load_state_dict(flax_to_state_dict(variables), strict=True)
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(x).to(dtype))
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n,d,f", [(37, 40, 72), (5, 24, 200), (9, 1000, 40)])
def test_ragged_widths_are_padded_exactly(n, d, f, dtype):
    """The zero padding of D and F to multiples of 16 (what the kernel
    receives on the card) leaves the twin's output as it is: bit for bit
    in bf16, and in f32 to the last bits (the CPU's BLAS blocks K 1000 and
    its padded 1008 apart, so the f32 sums run in another order); and the
    port matches the JAX kernel at the ragged width."""
    rng = np.random.default_rng(n)
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = _weights(d, f, n + 1)
    args = [torch.from_numpy(x).to(dtype)] + [
        a.to(dtype) for a in _port_weights(*w)]
    want = ffn_kernel.fused_ffn_reference(*args)
    padded = ffn_kernel._padded(*args)
    assert padded[0].shape[1] % 16 == 0 and padded[1].shape[0] % 16 == 0
    got = ffn_kernel.fused_ffn_reference(*padded)[:, :d]
    if dtype == torch.bfloat16:
        assert torch.equal(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                                   atol=1e-6)
    jax_out = jax.jit(jax_fused_ffn)(jnp.asarray(x, JAX_DTYPE[dtype]),
                                     *(jnp.asarray(a) for a in w))
    np.testing.assert_allclose(fused_ffn(*args).float().numpy(),
                               np.asarray(jax_out, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])
