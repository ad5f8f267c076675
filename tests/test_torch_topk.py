"""The port's ``topk_last`` twin against the JAX package's Pallas kernel
(interpret mode) and ``jax.lax.top_k``: values and ids exactly equal."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu.ops.pallas.topk_kernel import \
    topk_last as jax_topk_last
from asr_dfcnn_transformer_torch.kernels import topk_last, topk_last_reference
from tests._torch_cpu import use_two_threads

use_two_threads()


def _port(x, k):
    vals, ids = topk_last(torch.from_numpy(x), k)
    assert vals.dtype == torch.float32 and ids.dtype == torch.int32
    return vals.numpy(), ids.numpy()


def _check(x, k, *, kernel: bool = True, lax: bool = True):
    """Hold the twin to the JAX kernel (``kernel``) and to lax.top_k
    (``lax``), bit for bit."""
    vals, ids = _port(x, k)
    assert vals.shape == ids.shape == x.shape[:-1] + (k,)
    if kernel:
        kv, ki = jax_topk_last(jnp.asarray(x), k, interpret=True)
        np.testing.assert_array_equal(ids, np.asarray(ki))
        np.testing.assert_array_equal(vals, np.asarray(kv))
    if lax:
        lv, li = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(ids, np.asarray(li))
        np.testing.assert_array_equal(vals, np.asarray(lv))


def test_random_against_kernel():
    x = np.random.default_rng(0).standard_normal((4, 7, 96)).astype(
        np.float32)
    _check(x, 8)


@pytest.mark.parametrize("seed,shape,k", [(1, (6, 131), 5), (2, (9, 40), 8),
                                          (3, (3, 10, 24), 6)])
def test_quantised_ties(seed, shape, k):
    """Coarse values force many exact ties: ties go to the lower index,
    pick for pick as lax.top_k orders them. ``+ 0.0`` turns -0.0 into 0.0:
    lax.top_k puts 0.0 before -0.0, while the JAX kernel and the port
    compare them equal (and keep the lower index)."""
    x = np.round(np.random.default_rng(seed).standard_normal(shape) * 2) / 2
    _check((x + 0.0).astype(np.float32), k, kernel=seed == 1)


def test_all_equal_rows_and_k_equals_v():
    _check(np.zeros((3, 9), np.float32), 9)


def test_mask_value_entries():
    """Entries already at the mask value -1e30."""
    x = np.random.default_rng(4).standard_normal((5, 17)).astype(np.float32)
    x[:, ::3] = -1e30
    _check(x, 10)


def test_neg_inf_entries():
    """-inf entries: with k below the finite count the picks are
    lax.top_k's; past it the masked picks come back, as in the JAX
    kernel (lax.top_k would go on to the -inf entries)."""
    x = np.random.default_rng(5).standard_normal((4, 12)).astype(np.float32)
    x[:, ::2] = -np.inf
    x[3] = -np.inf                                  # a row of only -inf
    _check(x[:3], 6, kernel=False)                  # 6 finite a row
    _check(x, 9, lax=False)
    vals, ids = _port(x, 9)
    assert (vals[:3, 6:] == -1e30).all()            # masked picks again
    assert (ids[3] == 0).all() and vals[3, 0] == -np.inf


@pytest.mark.parametrize("shape,k", [((257, 40), 3), ((2, 3, 2, 19), 2)])
def test_2d_and_4d_leading_dims(shape, k):
    x = np.random.default_rng(6).standard_normal(shape).astype(np.float32)
    _check(x, k, kernel=len(shape) == 4)


def test_k_greater_than_v_raises():
    with pytest.raises(ValueError, match="exceeds"):
        topk_last(torch.zeros(2, 3), 4)
    with pytest.raises(ValueError, match="exceeds"):
        topk_last_reference(torch.zeros(2, 3), 4)
