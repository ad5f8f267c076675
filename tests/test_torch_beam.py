"""The port's CTC prefix beam search against the JAX package's.

``beam_search_reference`` (the twin of the ``beam_search`` kernel) is held
to the JAX Pallas kernel in interpret mode (row-major layout) on a few
cases and to the scan backend on the rest, on the same log-probs and top-k
tables; the port's ``ctc_beam_search_decode`` and its streaming trio are
held to the JAX functions end to end. Prefixes, lengths and ids must be
equal; log-probabilities agree within rtol 1e-5, atol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from asr_dfcnn_transformer_tpu.ops import ctc_decode as jdec
from asr_dfcnn_transformer_tpu.ops.pallas import beam_kernel
from asr_dfcnn_transformer_torch.kernels import (beam_search,
                                                 beam_search_reference,
                                                 topk_last_reference)
from asr_dfcnn_transformer_torch.kernels import beam as kbeam
from asr_dfcnn_transformer_torch.ops import (ctc_beam_search_decode,
                                             ctc_beam_search_stream_best,
                                             ctc_beam_search_stream_init,
                                             ctc_beam_search_stream_step,
                                             ctc_greedy_decode)
from asr_dfcnn_transformer_torch.ops.ctc_decode import _beam_finish
from tests._torch_cpu import use_two_threads

use_two_threads()
TOL = dict(rtol=1e-5, atol=1e-5)


def _random(seed, b, t, v, scale=2.0):
    rng = np.random.default_rng(seed)
    return (scale * rng.standard_normal((b, t, v))).astype(np.float32)


def _peaked(path, b, v):
    logits = np.full((b, len(path), v), -5.0, np.float32)
    for t, c in enumerate(path):
        logits[:, t, c] = 5.0
    return logits


def _twin(lp, lens, w, k, blank, lcap):
    """The port's twin on the JAX log-probs, with the twin's own top-k."""
    lp_t = torch.from_numpy(np.array(lp))
    top_lp, top_ids = topk_last_reference(lp_t, k)
    out = beam_search(lp_t, top_lp, top_ids, torch.from_numpy(lens),
                      beam_width=w, topk=k, blank=blank, max_decode_len=lcap)
    return [o.numpy() for o in out]


# (name, logits, lens, beam_width, topk, blank_id, max_decode_len)
CASES = {
    "random": (_random(0, 4, 20, 10), [20, 15, 3, 20], 4, 5, -1, 8),
    "peaked": (_peaked([7, 3, 3, 7, 4, 7, 5, 5, 7, 7, 6, 7], 2, 8), [12, 12],
               4, 4, -1, 6),
    "odd_batch": (_random(3, 3, 10, 6, 1.0), [10, 1, 8], 3, 3, -1, 5),
    # W > K + 1: live candidates run out; the 1-frame row keeps dead beams
    # to the end, so their tie order (lower candidate index) is compared
    "exhausted": (_random(7, 3, 10, 12), [10, 7, 1], 6, 2, -1, 6),
    "small_vocab": (_random(11, 3, 14, 5), [14, 4, 13], 8, 8, -1, 8),
    "topk_clamped": (_peaked([0, 5, 2, 2, 5, 3, 5, 3, 1, 5, 5, 1], 1, 6),
                     [12], 4, 8, 5, 8),
    "blank_not_last": (_random(5, 5, 16, 9), [16, 9, 12, 5, 16], 5, 4, 2, 7),
    "zero_length": (_random(9, 4, 12, 11), [12, 0, 6, 12], 4, 3, -1, 5),
    "cap_reached": (_random(13, 3, 30, 40, 4.0), [30, 30, 21], 6, 6, -1, 5),
}
KERNEL_CASES = ("random", "exhausted", "zero_length")


def _lp(logits):
    return jax.nn.log_softmax(jnp.asarray(logits), axis=-1)


@pytest.mark.parametrize("name", KERNEL_CASES)
def test_twin_matches_pallas_kernel(name):
    """Against the row-major Pallas kernel in interpret mode, on the same
    log-probs and top-k tables."""
    logits, lens, w, k, blank_id, lcap = CASES[name]
    lens = np.asarray(lens, np.int32)
    v = logits.shape[-1]
    blank, k = blank_id % v, min(k, v)
    lp = _lp(logits)
    top_lp, top_ids = jdec._topk_last_xla(lp, k)
    want = beam_kernel.beam_search(lp, top_lp, top_ids, jnp.asarray(lens),
                                   beam_width=w, topk=k, blank=blank,
                                   max_decode_len=lcap, interpret=True,
                                   batch_block=8)
    got = _twin(lp, lens, w, k, blank, lcap)
    for g, x, what in zip(got[:2], want[:2], ("prefixes", "lengths")):
        np.testing.assert_array_equal(g, np.asarray(x), err_msg=what)
    for g, x, what in zip(got[2:], want[2:], ("pb", "pnb")):
        np.testing.assert_allclose(g, np.asarray(x), err_msg=what, **TOL)


@pytest.mark.parametrize("name", sorted(CASES))
def test_twin_matches_scan_backend(name):
    """Against ``ctc_beam_search_decode(backend="scan", return_all=True)``
    on the same log-probs: every beam's prefix, length and total."""
    logits, lens, w, k, blank_id, lcap = CASES[name]
    lens = np.asarray(lens, np.int32)
    v = logits.shape[-1]
    blank, k = blank_id % v, min(k, v)
    want = jdec.ctc_beam_search_decode(
        jnp.asarray(logits), jnp.asarray(lens), beam_width=w, topk=k,
        blank_id=blank_id, max_decode_len=lcap, return_all=True,
        backend="scan")
    pref, plen, pb, pnb = _twin(_lp(logits), lens, w, k, blank, lcap)
    got = _beam_finish(*(torch.from_numpy(x) for x in (pref, plen, pb, pnb)),
                       True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **TOL)
    if name == "zero_length":                    # untouched initial state
        assert (plen[1] == 0).all() and pb[1, 0] == 0.0


@pytest.mark.parametrize("return_all", [False, True])
@pytest.mark.parametrize("name", ["random", "blank_not_last", "cap_reached"])
def test_decode_matches_jax(name, return_all):
    """The port's whole decode (its own log-softmax and top-k) against the
    JAX one."""
    logits, lens, w, k, blank_id, lcap = CASES[name]
    kw = dict(beam_width=w, topk=k, blank_id=blank_id, max_decode_len=lcap,
              return_all=return_all)
    want = jdec.ctc_beam_search_decode(jnp.asarray(logits),
                                       jnp.asarray(np.asarray(lens)), **kw)
    got = ctc_beam_search_decode(torch.from_numpy(logits),
                                 torch.tensor(lens), **kw)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **TOL)
    assert got[1].dtype == torch.int32


def test_peaked_lattice_probe():
    """[B, T, V] at -5 with +5 along a frame path, blank last: greedy and
    beam both recover the collapsed labels."""
    logits, lens, *_ = CASES["peaked"]
    x, n = torch.from_numpy(logits), torch.tensor(lens)
    ids, length, nlp = ctc_beam_search_decode(x, n, beam_width=4, topk=4,
                                              max_decode_len=6)
    g_ids, g_len = ctc_greedy_decode(x, n, max_output_len=6)
    for row in range(2):
        assert ids[row, :4].tolist() == [3, 4, 5, 6] and length[row] == 4
        assert g_ids[row, :4].tolist() == [3, 4, 5, 6] and g_len[row] == 4
    assert (ids[:, 4:] == 0).all() and (nlp < 1.0).all()


@pytest.mark.parametrize("chunk", [1, 3, None])
def test_stream_matches_jax_and_offline(chunk):
    """The streaming trio over chunks of 1, 3 or all frames: equal to the
    JAX trio, and to the offline search on the same log-probs."""
    b, t, v, w, k, lcap = 3, 13, 9, 4, 3, 6
    lp = np.array(_lp(_random(21, b, t, v)))
    state = ctc_beam_search_stream_init(b, w, lcap, device="cpu")
    jstate = jdec.ctc_beam_search_stream_init(b, w, lcap)
    step = chunk or t
    for s in range(0, t, step):
        part = lp[:, s:s + step]
        state = ctc_beam_search_stream_step(state, torch.from_numpy(part),
                                            beam_width=w, topk=k)
        jstate = jdec.ctc_beam_search_stream_step(jstate, jnp.asarray(part),
                                                  topk=k)
    got = ctc_beam_search_stream_best(state)
    want = jdec.ctc_beam_search_stream_best(jstate)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **TOL)
    pref, plen, pb, pnb = _twin(lp, np.full(b, t, np.int32), w, k, v - 1,
                                lcap)
    off = _beam_finish(*(torch.from_numpy(x) for x in (pref, plen, pb, pnb)),
                       False)
    for g, o in zip(got, off):
        assert torch.equal(g, o)


def test_stream_frame_counts_and_width_check():
    """Per-row frame counts freeze rows as the JAX step does; a beam_width
    that disagrees with the state raises."""
    b, t, v, w, k, lcap = 3, 8, 7, 3, 3, 5
    lp = np.array(_lp(_random(23, b, t, v)))
    counts = np.array([8, 0, 5], np.int32)
    state = ctc_beam_search_stream_step(
        ctc_beam_search_stream_init(b, w, lcap, device="cpu"),
        torch.from_numpy(lp), topk=k, frame_counts=torch.from_numpy(counts))
    jstate = jdec.ctc_beam_search_stream_step(
        jdec.ctc_beam_search_stream_init(b, w, lcap), jnp.asarray(lp),
        topk=k, frame_counts=jnp.asarray(counts))
    got = ctc_beam_search_stream_best(state)
    want = jdec.ctc_beam_search_stream_best(jstate)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), **TOL)
    with pytest.raises(ValueError, match="disagrees"):
        ctc_beam_search_stream_step(state, torch.from_numpy(lp[:, :1]),
                                    beam_width=w + 1)


def test_beam_search_checks_its_inputs():
    lp = torch.zeros(2, 4, 5)
    top_lp, top_ids = topk_last_reference(lp, 3)
    lens = torch.tensor([4, 4], dtype=torch.int32)
    kw = dict(beam_width=2, topk=3, blank=4, max_decode_len=3)
    with pytest.raises(ValueError, match="top_ids"):
        beam_search(lp, top_lp, top_ids.long(), lens, **kw)
    with pytest.raises(ValueError, match="lens"):
        beam_search(lp, top_lp, top_ids, lens.long(), **kw)
    with pytest.raises(ValueError, match="blank"):
        beam_search(lp, top_lp, top_ids, lens, **dict(kw, blank=5))
    out = beam_search_reference(lp, top_lp, top_ids, lens, **kw)
    assert [tuple(o.shape) for o in out] == [(2, 2, 3), (2, 2), (2, 2),
                                             (2, 2)]


# (lp shape [B, T, V], lens, W, K, L): the served path's W = K = 8 and L 100
# with its frozen rows (lens 0 and 1); L 6 on a lattice long enough that
# lengths reach the cap, so that L - 1 is written again and again; W > K + 1
BACKPOINTER_CASES = {
    "path": ((8, 200, 1536), [200, 0, 150, 50, 100, 173, 200, 1], 8, 8, 100),
    "cap": ((3, 40, 12), [40, 1, 0], 4, 4, 6),
    "exhausted": ((3, 10, 12), [10, 7, 1], 6, 2, 6),
}


@pytest.mark.parametrize("name", sorted(BACKPOINTER_CASES))
def test_backpointers_rebuild_the_twin_prefixes(name):
    """The kernel records a back-pointer per frame and beam and writes the
    prefixes by one trace-back: recorded frame by frame through
    ``beam_step_backpointers`` and walked by ``trace_back`` (the kernel's
    walk in Python), they rebuild the twin's prefixes exactly."""
    shape, lens, w, k, lcap = BACKPOINTER_CASES[name]
    rng = np.random.default_rng(sum(shape))
    lp = torch.log_softmax(torch.from_numpy(
        (3.0 * rng.standard_normal(shape)).astype(np.float32)), -1)
    top_lp, top_ids = topk_last_reference(lp, k)
    lens = torch.tensor(lens, dtype=torch.int32)
    blank = shape[-1] - 1
    want = beam_search_reference(lp, top_lp, top_ids, lens, beam_width=w,
                                 topk=k, blank=blank, max_decode_len=lcap)
    state = kbeam.beam_state_init(shape[0], w, lcap, lp.device)
    bps = []
    for t in range(shape[1]):
        state, bp = kbeam.beam_step_backpointers(
            state, lp[:, t], top_lp[:, t], top_ids[:, t], t < lens,
            blank=blank)
        bps.append(bp)
    bps = torch.stack(bps)
    assert torch.equal(state[0], want[0]) and torch.equal(state[1], want[1])
    got = kbeam.trace_back(bps, state[1], lcap)
    assert torch.equal(got, want[0])
    # frozen rows record only stays; the tables hold each kind of entry
    for row in np.flatnonzero(lens.numpy() <= 1):
        assert not (bps[int(lens[row]):, row] & 0x80).any()
    assert (bps & 0x80).any() and not (bps & 0x80).all()
    if name == "cap":
        assert int(want[1].max()) == lcap           # lengths reach the cap
        # an extension of a prefix at the cap scores NEG_INF, and a stay
        # always outranks it, so here L - 1 is written once per lineage;
        # the walk's latest-wins rule, on a hand-built lineage at L 2:
        # 5 at 0, 7 at 1, then 9 at 1 again from the cap
        hand = torch.tensor([0x80 | 5 << 9, 0x80 | 7 << 9,
                             0x80 | 0x100 | 9 << 9]).view(3, 1, 1)
        assert kbeam.trace_back(hand, torch.tensor([[2]]), 2).tolist() \
            == [[[5, 9]]]
