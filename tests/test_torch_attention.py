"""The port's masked-attention twin against the JAX masked_flash_attention
(Pallas, interpret mode on the CPU) and the einsum path's attention_mask.

The CUDA kernel is held against this twin on the card by chip_smoke.py.
"""

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
from asr_dfcnn_transformer_torch.kernels import masked_attention
from asr_dfcnn_transformer_torch.models.layers import attention_mask

torch.set_num_threads(2)

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
