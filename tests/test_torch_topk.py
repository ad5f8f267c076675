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


def _groups(v):
    """Groups of 128 a lane that ``asr_topk_last`` launches for V."""
    g = -(-v // 128)
    return next(n for n in (1, 2, 4, 8, 12, 16) if g <= n)


def _ordered(v):
    """``csrc/topk.cu`` ordered(): the float32's order as a uint32 key,
    -0.0 folded onto +0.0."""
    u = np.asarray(v, np.float32).view(np.uint32).copy()
    u[u == 0x80000000] = 0
    return np.where(u & 0x80000000, ~u, u | 0x80000000).astype(np.uint32)


def _pick(a, b):
    """(values, slots) over the lanes: b's where strictly larger."""
    take = b[0] > a[0]
    return np.where(take, b[0], a[0]), np.where(take, b[1], a[1])


def _group_best(q, g):
    slot = [np.full(q.shape[0], 4 * g + c) for c in range(4)]
    return _pick(_pick((q[:, 0], slot[0]), (q[:, 1], slot[1])),
                 _pick((q[:, 2], slot[2]), (q[:, 3], slot[3])))


def _tree(gb, lo, hi):
    if hi - lo == 1:
        return gb[lo]
    mid = (lo + hi + 1) // 2
    return _pick(_tree(gb, lo, mid), _tree(gb, mid, hi))


def _topk_lanes(row, k):
    """A numpy mirror of ``topk_last_kernel`` on one row: lane l holds
    elements 128 g + 4 l + c (-inf past V); each lane's best of each group
    and of its groups by trees in which the higher indices win only on a
    strictly larger value; a round's pick is the largest ``_ordered`` key
    over the lanes and, among the lanes at it, the least index; only the
    owning lane masks the pick to -1e30 and rescans."""
    v = row.size
    g_n = _groups(v)
    idx = (128 * np.arange(g_n)[None, :, None] + 4 * np.arange(32)[:, None,
                                                                  None]
           + np.arange(4)[None, None, :])
    r = np.where(idx < v, row[np.minimum(idx, v - 1)],
                 np.float32(-np.inf)).astype(np.float32)
    gb = [_group_best(r[:, g], g) for g in range(g_n)]
    best_v, best_s = _tree(gb, 0, g_n)
    best_v, best_s = best_v.copy(), best_s.copy()
    lane = np.arange(32)
    vals, ids = [], []
    for _ in range(k):
        key = _ordered(best_v)
        at_idx = 128 * (best_s >> 2) + 4 * lane + (best_s & 3)
        at = np.where(key == key.max(), at_idx, np.iinfo(np.int64).max).min()
        (owner,) = np.nonzero(at_idx == at)[0]
        vals.append(best_v[owner])
        ids.append(at)
        g, c = best_s[owner] >> 2, best_s[owner] & 3
        r[owner, g, c] = np.float32(NEG_INF_MASK)
        gb[g] = tuple(np.where(lane == owner, new, old) for new, old in
                      zip(_group_best(r[:, g], g), gb[g]))
        nv, ns = _tree(gb, 0, g_n)
        best_v[owner], best_s[owner] = nv[owner], ns[owner]
    return np.array(vals, np.float32), np.array(ids, np.int32)


NEG_INF_MASK = -1e30


def _mirror_rows(v, rng):
    """Rows at V: normal values, quantised ties with -0.0 and 0.0, -inf
    entries, entries at -1e30, fewer than 32 above -1e30, and only
    -inf."""
    normal = rng.standard_normal(v)
    ties = np.round(rng.standard_normal(v) * 2) / 2     # holds -0.0
    ties[rng.uniform(size=v) < 0.3] = -0.0
    some_inf = rng.standard_normal(v)
    some_inf[::2] = -np.inf
    masked = rng.standard_normal(v)
    masked[1::3] = NEG_INF_MASK
    few = np.full(v, -np.inf)
    few[rng.permutation(v)[:min(v, 3)]] = rng.standard_normal(min(v, 3))
    few[-1] = NEG_INF_MASK
    return np.stack([normal, ties, some_inf, masked, few,
                     np.full(v, -np.inf)]).astype(np.float32)


@pytest.mark.parametrize("v", [1, 5, 31, 33, 127, 1536])
def test_lane_mirror_matches_pallas_interpret(v):
    """The kernel's selection (lane layout, trees, cached bests, the key
    with -0.0 folded, the least index among the lanes at the key), held to
    the JAX kernel in interpret mode, ids and values, at k 1, 8 and 32
    (k <= V): a round does not depend on k, so each k is a prefix of the
    JAX kernel's run at the largest one."""
    x = _mirror_rows(v, np.random.default_rng(v))
    k_max = min(32, v)
    jv, ji = (np.asarray(a) for a in jax_topk_last(jnp.asarray(x), k_max,
                                                  interpret=True))
    assert (x == 0).any() or v < 5
    for k in (1, 8, 32):
        if k > v:
            continue
        for i, row in enumerate(x):
            vals, ids = _topk_lanes(row, k)
            np.testing.assert_array_equal(ids, ji[i, :k])
            np.testing.assert_array_equal(vals, jv[i, :k])
