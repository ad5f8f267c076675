"""The port's StreamPool and StreamSessionManager (``infer/stream_pool.py``,
``infer/stream_sessions.py``): the pool against the JAX package's pool on
bridged weights (greedy and beam), then case for case as
tests/test_stream_pool.py and tests/test_stream_sessions.py hold the JAX
ones: a pool of N streams equals N independent recognizers, sessions equal
the single-stream engine, and the lifecycles."""

import threading
import time

import numpy as np
import pytest

from asr_dfcnn_transformer_tpu.infer.stream_pool import (
    StreamPool as JaxStreamPool)
from asr_dfcnn_transformer_torch.infer.stream_pool import StreamPool
from asr_dfcnn_transformer_torch.infer.stream_sessions import (
    StreamSessionManager)
from asr_dfcnn_transformer_torch.infer.streaming import IncrementalRecognizer
from tests.test_stream_pool import _chunks
from tests.test_torch_streaming import _pair, _port_pipeline, _signal
from tests._torch_cpu import use_two_threads

use_two_threads()


def _run_single(pipeline, sig, chunks, **kw):
    rec = IncrementalRecognizer(pipeline, cmvn="running", **kw)
    for c in chunks:
        rec.push(c)
    return rec.finalize()


def _interleaved(pool, sigs, chunk_lists):
    """Round-robin pushes, one batched step a round, then finalize."""
    slots = [pool.open() for _ in sigs]
    iters = [iter(cs) for cs in chunk_lists]
    pending = set(range(len(sigs)))
    while pending:
        for k in list(pending):
            c = next(iters[k], None)
            if c is None:
                pending.discard(k)
            else:
                pool.push(slots[k], c, step=False)
        pool.step()
    return [pool.finalize(slots[k]) for k in range(len(sigs))]


# ---- port against JAX --------------------------------------------------

@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_pool_matches_jax(decode):
    jpipe, pipe = _pair(with_lm=True, decode=decode, seed=6)
    sigs = [_signal(1.9, seed=1), _signal(2.7, seed=2), _signal(1.2, seed=4)]
    chunk_lists = [_chunks(s, sizes_seed=i) for i, s in enumerate(sigs)]
    kw = dict(cmvn="running", beam_width=4 if decode == "beam" else None)
    want = _interleaved(JaxStreamPool(jpipe, n_slots=4, **kw), sigs,
                        chunk_lists)
    got = _interleaved(StreamPool(pipe, n_slots=4, **kw), sigs, chunk_lists)
    assert got == want
    assert all(len(p) > 0 for p, _ in want)


# ---- the pool against N recognizers ------------------------------------

@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_pool_matches_independent_recognizers(decode):
    pipeline = _port_pipeline(decode=decode)
    sigs = [_signal(1.9, seed=1), _signal(2.7, seed=2),
            _signal(3.4, seed=3), _signal(1.2, seed=4)]
    chunk_lists = [_chunks(s, sizes_seed=i) for i, s in enumerate(sigs)]
    kw = dict(beam_width=4) if decode == "beam" else {}
    want = [_run_single(pipeline, s, cs, **kw)
            for s, cs in zip(sigs, chunk_lists)]
    got = _interleaved(StreamPool(pipeline, n_slots=4, cmvn="running", **kw),
                       sigs, chunk_lists)
    assert got == want


def test_pool_short_utterance_small_bucket():
    """A bucket smaller than the streaming window: the size-grouped
    finalize."""
    pipeline = _port_pipeline()
    sig = _signal(0.9, seed=7)
    want = _run_single(pipeline, sig, _chunks(sig, 5))
    pool = StreamPool(pipeline, n_slots=2, cmvn="running")
    s = pool.open()
    for c in _chunks(sig, 5):
        pool.push(s, c)
    assert pool.finalize(s) == want


def test_mixed_finalize_does_not_disturb_others():
    pipeline = _port_pipeline()
    a_sig, b_sig = _signal(2.2, seed=11), _signal(2.9, seed=12)
    want_a = _run_single(pipeline, a_sig, _chunks(a_sig, 1))
    want_b = _run_single(pipeline, b_sig, _chunks(b_sig, 2))
    pool = StreamPool(pipeline, n_slots=3, cmvn="running")
    a, b = pool.open(), pool.open()
    ca, cb = _chunks(a_sig, 1), _chunks(b_sig, 2)
    for c in ca:
        pool.push(a, c, step=False)
    for c in cb[: len(cb) // 2]:
        pool.push(b, c, step=False)
    pool.step()
    assert pool.finalize(a) == want_a
    for c in cb[len(cb) // 2:]:
        pool.push(b, c)
    assert pool.finalize(b) == want_b


def test_beam_finalize_tail_longer_than_chunk():
    """An end-aligned finalize tail of 16 rows > chunk_logits 8 drains over
    several plans of one window."""
    pipeline = _port_pipeline(decode="beam")
    sig = _signal(1.26, seed=91)
    kw = dict(decode="beam", beam_width=4, chunk_logits=8)
    want = _run_single(pipeline, sig, _chunks(sig, 92), **kw)
    pool = StreamPool(pipeline, n_slots=2, cmvn="running", **kw)
    s = pool.open()
    for c in _chunks(sig, 92):
        pool.push(s, c)
    assert pool.finalize(s) == want


def test_beam_slot_reuse_after_close():
    pipeline = _port_pipeline(decode="beam")
    sig = _signal(1.3, seed=41)
    want = _run_single(pipeline, sig, [sig], decode="beam", beam_width=4)
    pool = StreamPool(pipeline, n_slots=1, cmvn="running", decode="beam",
                      beam_width=4)
    s0 = pool.open()
    pool.push(s0, _signal(1.0, seed=42))
    pool.finalize(s0)
    pool.close(s0)
    s1 = pool.open()            # the reused slot's beam row starts fresh
    assert s1 == s0
    pool.push(s1, sig)
    assert pool.finalize(s1) == want


def test_partials_match_single_stream():
    pipeline = _port_pipeline(with_lm=True)
    sig = _signal(2.0, seed=51)
    rec = IncrementalRecognizer(pipeline, cmvn="running")
    pool = StreamPool(pipeline, n_slots=2, cmvn="running")
    s = pool.open()
    for c in _chunks(sig, 52):
        rec.push(c)
        pool.push(s, c)
        assert pool.partial(s) == rec.partial()
    assert pool.finalize(s) == rec.finalize()
    assert pool.partial(s) == pool.partial(s)       # cached once final


def test_partials_covers_all_active():
    pipeline = _port_pipeline(with_lm=True)
    pool = StreamPool(pipeline, n_slots=3, cmvn="running")
    a, b = pool.open(), pool.open()
    pool.push(a, _signal(1.1, seed=61), step=False)
    pool.push(b, _signal(1.4, seed=62), step=False)
    pool.step()
    out = pool.partials()
    assert set(out) == {a, b}
    for p, h in out.values():
        assert isinstance(p, list) and isinstance(h, str)


def test_capacity_reuse_and_finalized_slots():
    pipeline = _port_pipeline()
    pool = StreamPool(pipeline, n_slots=2, cmvn="running")
    a, b = pool.open(), pool.open()
    with pytest.raises(RuntimeError):
        pool.open()
    pool.close(a)
    assert pool.open() == a
    pool.close(b), pool.close(a)
    assert pool.active_slots == []
    s = pool.open()
    pool.push(s, _signal(1.0, seed=71))
    pool.finalize(s)
    with pytest.raises(ValueError):
        pool.push(s, _signal(0.5, seed=72))
    with pytest.raises(KeyError):
        pool.push(s + 1, _signal(0.5, seed=73))
    with pytest.raises(ValueError, match="n_slots"):
        StreamPool(pipeline, n_slots=0)


# ---- sessions ----------------------------------------------------------

@pytest.fixture(scope="module")
def pipeline():
    return _port_pipeline(with_lm=True)


def test_concurrent_sessions_match_single_stream(pipeline):
    sigs = [_signal(1.9, seed=11), _signal(2.7, seed=12),
            _signal(3.3, seed=13)]
    chunk_lists = [_chunks(s, sizes_seed=i) for i, s in enumerate(sigs)]
    want = [_run_single(pipeline, s, cs)
            for s, cs in zip(sigs, chunk_lists)]
    got = [None] * len(sigs)
    errors = []
    with StreamSessionManager(pipeline, n_slots=4, max_wait_ms=20.0) as mgr:
        def client(k):
            try:
                tok = mgr.open()
                for c in chunk_lists[k]:
                    mgr.push(tok, c, want_partial=False)
                got[k] = mgr.finish(tok)
            except Exception as e:  # surfaced below
                errors.append(e)
        threads = [threading.Thread(target=client, args=(k,))
                   for k in range(len(sigs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        assert not errors
        st = mgr.stats()
    assert got == want
    assert st["finished"] == len(sigs) and st["active"] == 0
    assert st["rounds"] < st["pushes"]          # pushes shared rounds


def test_partial_progresses_and_want_partial_none(pipeline):
    sig = _signal(2.2, seed=21)
    half = len(sig) // 2
    with StreamSessionManager(pipeline, n_slots=2) as mgr:
        tok = mgr.open()
        assert mgr.push(tok, sig[:half], want_partial=False) is None
        hyp = mgr.push(tok, sig[half:])
        assert isinstance(hyp, tuple) and isinstance(hyp[0], list) \
            and isinstance(hyp[1], str)
        final = mgr.finish(tok)
    assert final == _run_single(pipeline, sig, [sig[:half], sig[half:]])


def test_finish_with_tail_equals_push_then_finish(pipeline):
    sig = _signal(1.7, seed=31)
    cut = len(sig) * 2 // 3
    with StreamSessionManager(pipeline, n_slots=2) as mgr:
        a = mgr.open()
        mgr.push(a, sig[:cut], want_partial=False)
        mgr.push(a, sig[cut:], want_partial=False)
        via_push = mgr.finish(a)
        b = mgr.open()
        mgr.push(b, sig[:cut], want_partial=False)
        via_tail = mgr.finish(b, tail=sig[cut:])
    assert via_push == via_tail


def test_unknown_and_finished_tokens_raise(pipeline):
    with StreamSessionManager(pipeline, n_slots=1) as mgr:
        with pytest.raises(KeyError):
            mgr.push("nope", np.zeros(100, np.float32))
        tok = mgr.open()
        mgr.finish(tok)
        with pytest.raises(KeyError):
            mgr.push(tok, np.zeros(100, np.float32))


def test_slot_exhaustion_and_reuse(pipeline):
    with StreamSessionManager(pipeline, n_slots=1) as mgr:
        tok = mgr.open()
        with pytest.raises(RuntimeError):
            mgr.open()
        mgr.finish(tok)
        tok2 = mgr.open()
        mgr.abort(tok2)
        assert mgr.stats()["aborted"] == 1
        mgr.abort(mgr.open())


def test_idle_expiry_reclaims_slot(pipeline):
    with StreamSessionManager(pipeline, n_slots=1,
                              idle_timeout_s=0.3) as mgr:
        tok = mgr.open()
        mgr.push(tok, _signal(0.5, seed=41), want_partial=False)
        deadline = time.monotonic() + 10.0
        while mgr.stats()["expired"] == 0:
            assert time.monotonic() < deadline, "session never expired"
            time.sleep(0.1)
        with pytest.raises(KeyError):
            mgr.push(tok, np.zeros(100, np.float32))
        mgr.abort(mgr.open())


def test_max_stream_seconds_rejects(pipeline):
    with StreamSessionManager(pipeline, n_slots=1,
                              max_stream_seconds=0.05) as mgr:
        tok = mgr.open()
        with pytest.raises(ValueError, match="max_stream_seconds"):
            mgr.push(tok, np.zeros(1600, np.float32))
        mgr.push(tok, np.zeros(400, np.float32), want_partial=False)
        with pytest.raises(ValueError, match="max_stream_seconds"):
            mgr.finish(tok, tail=np.zeros(1600, np.float32))
        mgr.finish(tok)


def test_abort_discards_and_frees(pipeline):
    with StreamSessionManager(pipeline, n_slots=1) as mgr:
        tok = mgr.open()
        mgr.push(tok, _signal(1.5, seed=51), want_partial=False)
        mgr.abort(tok)
        with pytest.raises(KeyError):
            mgr.finish(tok)
        st = mgr.stats()
        assert st["aborted"] == 1 and st["active"] == 0


def test_beam_decode_sessions_match_single_stream():
    beam = _port_pipeline(decode="beam")
    sig = _signal(2.4, seed=61)
    chunks = _chunks(sig, sizes_seed=7)
    want = _run_single(beam, sig, chunks)
    with StreamSessionManager(beam, n_slots=2) as mgr:
        tok = mgr.open()
        for c in chunks:
            mgr.push(tok, c, want_partial=False)
        assert mgr.finish(tok) == want


def test_closed_manager_rejects(pipeline):
    mgr = StreamSessionManager(pipeline, n_slots=1)
    tok = mgr.open()
    mgr.close()
    with pytest.raises(RuntimeError):
        mgr.open()
    with pytest.raises(RuntimeError):
        mgr.push(tok, np.zeros(10, np.float32))


def test_constructor_errors_surface(pipeline):
    with pytest.raises(ValueError, match="n_slots"):
        StreamSessionManager(pipeline, n_slots=0)
    with pytest.raises(ValueError, match="cmvn"):
        StreamSessionManager(pipeline, n_slots=1, cmvn="nope")
