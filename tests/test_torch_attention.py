"""The port's masked-attention twins against the JAX masked_flash_attention
(Pallas, interpret mode on the CPU) and the einsum path's attention_mask:
the forward with and without dropout, and the VJP through the port's
``MaskedAttention`` autograd Function.

The CUDA kernels are held against these twins on the card by chip_smoke.py.
"""

import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu.models.layers import (
    attention_mask as jax_attention_mask,
)
from asr_dfcnn_transformer_tpu.ops.pallas.attn_kernel import (
    masked_flash_attention,
)
from asr_dfcnn_transformer_torch.kernels import (MaskedAttention, cmvn,
                                                 log_mel, masked_attention)
from asr_dfcnn_transformer_torch.models.layers import attention_mask
from tests._torch_cpu import use_two_threads

use_two_threads()

_DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
           "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, b, h, tq, tk, dh, ragged, full_invalid_row=False):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, tq, dh)).astype(np.float32)
    k = rng.standard_normal((b, h, tk, dh)).astype(np.float32)
    v = rng.standard_normal((b, h, tk, dh)).astype(np.float32)
    k_valid = None
    if ragged:
        # non-contiguous validity: the contract is any boolean vector
        k_valid = rng.uniform(size=(b, tk)) > 0.3
        k_valid[:, 0] = True
    if full_invalid_row:
        k_valid = np.ones((b, tk), bool) if k_valid is None else k_valid
        k_valid[0] = False
    return q, k, v, k_valid


def _both(q, k, v, k_valid, causal, dtype):
    jdt, tdt, _ = _DTYPES[dtype]
    want = masked_flash_attention(
        *(jnp.asarray(x, jdt) for x in (q, k, v)),
        None if k_valid is None else jnp.asarray(k_valid), causal=causal)
    got = masked_attention(
        *(torch.from_numpy(x).to(tdt) for x in (q, k, v)),
        None if k_valid is None else torch.from_numpy(k_valid),
        causal=causal)
    assert got.shape == tuple(want.shape) and got.dtype == tdt
    return got.float().numpy(), np.asarray(want, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,tq,tk,dh,causal,ragged", [
    (4, 8, 64, 64, 64, True, True),      # LM shape class
    (2, 8, 100, 100, 64, True, False),   # LM position cap
    (2, 2, 7, 7, 32, True, True),        # tiny everything
    (3, 4, 24, 40, 64, False, True),     # rectangular (Tq != Tk)
    (3, 4, 24, 40, 64, True, True),      # rectangular causal (Tq != Tk)
])
def test_twin_matches_masked_flash(b, h, tq, tk, dh, causal, ragged, dtype):
    got, want = _both(*_inputs(0, b, h, tq, tk, dh, ragged), causal, dtype)
    tol = _DTYPES[dtype][2]
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_fully_invalid_row_is_uniform(dtype, causal):
    """A batch row whose keys are ALL invalid reproduces the einsum path's
    uniform softmax over the -1e9 scores: finite, the mean of v."""
    q, k, v, k_valid = _inputs(2, 2, 2, 16, 16, 32, ragged=True,
                               full_invalid_row=True)
    got, want = _both(q, k, v, k_valid, causal, dtype)
    tol = _DTYPES[dtype][2]
    assert np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=tol, rtol=tol)
    if dtype == "float32":
        mean_v = np.broadcast_to(v[0].mean(axis=1, keepdims=True), got[0].shape)
        np.testing.assert_allclose(got[0], mean_v, atol=1e-5, rtol=1e-5)


def test_attention_mask_matches_jax():
    rng = np.random.default_rng(4)
    k_valid = rng.uniform(size=(3, 9)) > 0.4
    q_valid = np.ones((3, 6), bool)
    for causal in (False, True):
        want = np.asarray(jax_attention_mask(jnp.asarray(q_valid),
                                             jnp.asarray(k_valid), causal))
        got = attention_mask(torch.from_numpy(q_valid),
                             torch.from_numpy(k_valid), causal).numpy()
        np.testing.assert_array_equal(got, want)


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros((1, 2, 4, 8))
    with pytest.raises(ValueError, match="disagree"):
        masked_attention(q, torch.zeros((1, 2, 4, 4)), torch.zeros((1, 2, 4, 4)))
    with pytest.raises(ValueError, match="dtype"):
        masked_attention(q, q.double(), q)
    with pytest.raises(ValueError, match="Dh"):
        big = torch.zeros((1, 1, 2, 130))
        masked_attention(big, big, big)
    with pytest.raises(ValueError, match="bool"):
        masked_attention(q, q, q, torch.ones((1, 4)))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        m = q.to("meta")
        masked_attention(m, m, m)


def _vjp_both(q, k, v, k_valid, g, causal, dtype, keep):
    """(out, dq, dk, dv) from the JAX kernel's custom VJP (interpreted) and
    from the port's Function, on one shared numpy keep mask (or none)."""
    jdt, tdt, _ = _DTYPES[dtype]
    b, h, tq, _ = q.shape
    tk = k.shape[2]
    dmask = None
    if keep < 1.0:
        dmask = np.random.default_rng(11).uniform(size=(b, h, tq, tk)) < keep
    kv = jnp.asarray(k_valid)

    def jax_fn(q_, k_, v_):
        return masked_flash_attention(
            q_, k_, v_, kv, causal=causal,
            dropout_mask=None if dmask is None else jnp.asarray(dmask),
            keep_prob=keep, interpret=True)

    jq, jk, jv = (jnp.asarray(x, jdt) for x in (q, k, v))
    out, vjp = jax.vjp(jax_fn, jq, jk, jv)
    want = [out] + list(vjp(jnp.asarray(g, jdt)))

    tq_, tk_, tv_ = (torch.from_numpy(x).to(tdt).requires_grad_(True)
                     for x in (q, k, v))
    got_out = masked_attention(
        tq_, tk_, tv_, torch.from_numpy(k_valid), causal=causal,
        keep_mask=None if dmask is None else torch.from_numpy(dmask),
        keep_prob=keep)
    got = [got_out] + list(torch.autograd.grad(
        got_out, (tq_, tk_, tv_), torch.from_numpy(g).to(tdt)))
    return ([x.detach().float().numpy() for x in got],
            [np.asarray(x, np.float32) for x in want])


@pytest.mark.parametrize("keep", [1.0, 0.5])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vjp_matches_masked_flash(dtype, causal, keep):
    """dq, dk, dv (and the forward) against jax.vjp of the interpreted
    kernel, ragged keys with one fully invalid row, with and without a
    dropout keep mask at 0.5."""
    q, k, v, k_valid = _inputs(5, 3, 2, 12, 12, 32, ragged=True,
                               full_invalid_row=True)
    g = np.random.default_rng(6).standard_normal(q.shape).astype(np.float32)
    got, want = _vjp_both(q, k, v, k_valid, g, causal, dtype, keep)
    tol = _DTYPES[dtype][2]
    for name, x, y in zip(("out", "dq", "dk", "dv"), got, want):
        assert np.all(np.isfinite(x)), name
        np.testing.assert_allclose(x, y, atol=tol, rtol=tol, err_msg=name)


def test_vjp_rectangular_matches_masked_flash():
    q, k, v, k_valid = _inputs(7, 2, 2, 8, 20, 16, ragged=True)
    g = np.random.default_rng(8).standard_normal(q.shape).astype(np.float32)
    got, want = _vjp_both(q, k, v, k_valid, g, True, "float32", 0.5)
    for name, x, y in zip(("out", "dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(x, y, atol=1e-5, rtol=1e-5, err_msg=name)


def test_masked_attention_is_differentiable():
    """On the CPU the wrapper goes through the port's autograd Function, so
    q, k and v all receive gradients, as they must on the card."""
    q, k, v = (torch.randn(2, 2, 5, 8, requires_grad=True) for _ in range(3))
    out = masked_attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == f"{MaskedAttention.__name__}Backward"
    out.square().sum().backward()
    for x in (q, k, v):
        assert x.grad is not None and bool(torch.isfinite(x.grad).all())
        assert float(x.grad.abs().sum()) > 0


def test_front_end_kernels_refuse_grad():
    """log_mel and cmvn have no backward: an input that requires grad is
    refused rather than silently cut from the graph."""
    sig = torch.zeros((1, 800), requires_grad=True)
    lens = torch.tensor([800], dtype=torch.int32)
    with pytest.raises(ValueError, match="no backward"):
        log_mel(sig, lens, 3)
    feat = torch.zeros((1, 3, 200), requires_grad=True)
    with pytest.raises(ValueError, match="no backward"):
        cmvn(feat, torch.tensor([3], dtype=torch.int32))


def test_keep_mask_is_checked():
    q = torch.zeros((1, 2, 4, 8))
    with pytest.raises(ValueError, match="keep_mask"):
        masked_attention(q, q, q, keep_mask=torch.ones((1, 2, 4, 4)),
                         keep_prob=0.5)
    with pytest.raises(ValueError, match="keep_prob"):
        masked_attention(q, q, q,
                         keep_mask=torch.ones((1, 2, 4, 4), dtype=torch.bool),
                         keep_prob=0.0)


def test_backward_shared_memory_fits_every_forward_shape():
    """The backward kernel walks keys and queries in chunks, so its shared
    memory (``bwd_smem_bytes``, the mirror of csrc/attention.cu's layout)
    depends on Dh alone and fits the card's 232,448 bytes at every
    (Tq, Tk, Dh <= 128) the forward admits: here every Dh in both types and
    the f32 shapes of e2e training at bucket 1600 whose earlier
    one-block-per-(b, h) layout needed 294,624 bytes."""
    from asr_dfcnn_transformer_torch.kernels import attention as attn
    for dtype in (torch.float32, torch.bfloat16):
        need = [attn.bwd_smem_bytes(dh, dtype)
                for dh in range(1, attn.MAX_DH + 1)]
        assert max(need) <= attn.MAX_SMEM, (dtype, max(need))
        assert need == sorted(need)        # grows with Dh only
    assert attn.bwd_smem_bytes(64, torch.float32) < 100_000
    # the mirror's tiling is the kernel's (chip_smoke.py holds the mirror
    # to the C query on the card)
    src = (attn._build.CSRC / "attention.cu").read_text()
    consts = dict(re.findall(r"constexpr int (\w+) = (\d+);", src))
    assert int(consts["kKeyChunk"]) == attn._KEY_CHUNK
    assert int(consts["kQueryChunk"]) == attn._QUERY_CHUNK
    assert int(consts["kBwdWarps"]) == attn._BWD_WARPS
    assert int(consts["kBwdWarps"]) * int(consts["kRowsPerWarp"]) \
        == attn._BWD_QROWS
    assert int(consts["kBwdWarps"]) * int(consts["kKeysPerWarp"]) \
        == attn._BWD_KROWS
