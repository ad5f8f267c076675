"""Streaming recognition sessions: the server-side layer over StreamPool
(the port of ``infer/stream_sessions.py``).

The reference's live-audio surface is a blocking single-stream loop —
record, run the model, print (``lm_and_am/read_wav.py:14-57``). A
production speech server instead holds MANY concurrent client streams,
each pushing audio chunks at its own pace and asking for partial
hypotheses. :class:`StreamSessionManager` is that layer:

- **sessions**: opaque tokens map to :class:`~.stream_pool.StreamPool`
  slots, with idle expiry so an abandoned client cannot leak a slot;
- **coalescing**: all operations funnel through ONE dispatcher thread
  (the only thread that touches the device, mirroring
  :class:`~.serving.BatchingServer`'s model) which soaks concurrent
  pushes for ``max_wait_ms`` and drains them with a single batched
  ``pool.step()`` + at most one batched ``pool.partials()`` per round —
  N clients pushing simultaneously cost one device pass per stage, not N;
- **finalize batching**: concurrent ``finish()`` calls share one
  ``step(final_slots=...)`` (exactly what ``StreamPool.finalize`` runs
  per slot, grouped).

Results are exact w.r.t. the single-stream engine by construction: the
manager only sequences ``StreamPool`` calls, and the pool is pinned
token-for-token to N independent ``IncrementalRecognizer`` instances by
its own tests.
"""

from __future__ import annotations

import queue
import threading
import time
import uuid
from concurrent.futures import Future
from typing import Dict, List, Optional, Tuple

import numpy as np

__all__ = ["StreamSessionManager"]

Hyp = Tuple[List[str], str]


class _Op:
    __slots__ = ("kind", "token", "chunk", "want_partial", "future")

    def __init__(self, kind: str, token: Optional[str] = None,
                 chunk: Optional[np.ndarray] = None,
                 want_partial: bool = True):
        self.kind = kind            # "open" | "push" | "finish" | "abort"
        self.token = token
        self.chunk = chunk
        self.want_partial = want_partial
        self.future: Future = Future()


class _Session:
    __slots__ = ("slot", "last_active", "samples")

    def __init__(self, slot: int):
        self.slot = slot
        self.last_active = time.monotonic()
        self.samples = 0


class StreamSessionManager:
    """Token-addressed streaming sessions multiplexed over one StreamPool.

    Args:
      pipeline: a constructed :class:`~.pipeline.Pipeline`.
      n_slots: maximum concurrent streams (= the pool's batch dimension).
      max_wait_ms: dispatcher soak window after the first pending op.
      idle_timeout_s: sessions with no push/finish for this long are
        expired and their slot reclaimed (0 disables expiry).
      max_stream_seconds: pushes beyond this much total audio per stream
        are rejected (the decode is already bounded by the pool's
        ``max_logits``; this bounds the feature work too).
      pool_kw: forwarded to :class:`StreamPool` (decode, beam_width,
        chunk_logits, halo_frames, cmvn, ...).
    """

    def __init__(self, pipeline, n_slots: int = 8, *,
                 max_wait_ms: float = 5.0, idle_timeout_s: float = 600.0,
                 max_stream_seconds: float = 600.0,
                 sample_rate: int = 16000, **pool_kw):
        if n_slots <= 0:
            raise ValueError("n_slots must be positive")
        self.n_slots = n_slots
        self.max_wait_s = max_wait_ms / 1000.0
        self.idle_timeout_s = idle_timeout_s
        self.sample_rate = sample_rate
        self.max_stream_samples = int(max_stream_seconds * sample_rate)
        self._pipeline = pipeline
        self._pool_kw = pool_kw
        self._queue: "queue.Queue[Optional[_Op]]" = queue.Queue()
        self._sessions: Dict[str, _Session] = {}
        self._lock = threading.Lock()   # sessions map + counters
        self._closed = False
        self._counters = {"opened": 0, "finished": 0, "aborted": 0,
                          "expired": 0, "pushes": 0, "rounds": 0,
                          "rejected": 0}
        self._startup_error: Optional[BaseException] = None
        self._started = threading.Event()
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="asr-stream-dispatcher",
                                        daemon=True)
        self._thread.start()
        self._started.wait()
        if self._startup_error is not None:
            raise self._startup_error

    # ---- client API (any thread) ----------------------------------------

    def open(self, timeout: Optional[float] = None) -> str:
        """Claim a stream; returns its token. Raises RuntimeError when all
        ``n_slots`` are busy."""
        return self._submit(_Op("open"), timeout)

    def push(self, token: str, chunk: np.ndarray, *,
             want_partial: bool = True,
             timeout: Optional[float] = None) -> Optional[Hyp]:
        """Append audio to a stream. Returns the current (pinyin, hanzi)
        partial hypothesis, or None with ``want_partial=False`` (cheaper:
        skips the batched LM refresh for rounds nobody is reading)."""
        chunk = np.asarray(chunk, np.float32).reshape(-1)
        return self._submit(_Op("push", token, chunk, want_partial),
                            timeout)

    def finish(self, token: str, tail: Optional[np.ndarray] = None,
               timeout: Optional[float] = None) -> Hyp:
        """Flush the stream's tail and release its slot; returns the final
        (pinyin, hanzi) hypothesis. The token becomes invalid."""
        t = None if tail is None else np.asarray(tail,
                                                 np.float32).reshape(-1)
        return self._submit(_Op("finish", token, t), timeout)

    def abort(self, token: str, timeout: Optional[float] = None) -> None:
        """Drop a stream without decoding its tail; frees the slot."""
        return self._submit(_Op("abort", token), timeout)

    def stats(self) -> dict:
        with self._lock:
            out = dict(self._counters)
            out["active"] = len(self._sessions)
            out["n_slots"] = self.n_slots
        return out

    def close(self, timeout: float = 30.0) -> None:
        """Abort every active stream and stop the dispatcher."""
        with self._lock:
            if self._closed:
                return
            # set-then-put under the same lock _submit enqueues under:
            # every op that passed _submit's closed check sits BEFORE the
            # None sentinel in the FIFO queue, so the dispatcher resolves
            # it before exiting — no caller can be left waiting forever
            self._closed = True
            self._queue.put(None)
        self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def _submit(self, op: _Op, timeout: Optional[float]):
        with self._lock:
            if self._closed:
                raise RuntimeError("session manager is closed")
            self._queue.put(op)
        return op.future.result(timeout)

    # ---- dispatcher (owns the pool and all device work) ------------------

    def _dispatch_loop(self) -> None:
        try:
            from asr_dfcnn_transformer_torch.infer.stream_pool import (
                StreamPool)
            pool = StreamPool(self._pipeline, n_slots=self.n_slots,
                              **self._pool_kw)
        except BaseException as e:  # surface constructor errors to __init__
            self._startup_error = e
            self._started.set()
            return
        self._started.set()

        sweep_s = min(1.0, self.idle_timeout_s or 1.0)
        pending: List[_Op] = []
        stop = False
        while not (stop and not pending):
            if not pending and not stop:
                try:
                    item = self._queue.get(timeout=sweep_s)
                except queue.Empty:
                    self._sweep(pool)
                    continue
                if item is None:
                    stop = True
                    continue
                pending.append(item)
                deadline = time.monotonic() + self.max_wait_s
            while not stop:
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                try:
                    item = self._queue.get(timeout=remaining)
                except queue.Empty:
                    break
                if item is None:
                    stop = True
                else:
                    pending.append(item)
            if pending:
                self._execute(pool, pending)
                pending = []
            self._sweep(pool)
        # shutdown: release everything; fail any op that slipped into the
        # queue anyway (belt and braces — close()'s lock ordering should
        # make this unreachable)
        while True:
            try:
                item = self._queue.get_nowait()
            except queue.Empty:
                break
            if item is not None and not item.future.done():
                item.future.set_exception(
                    RuntimeError("session manager is closed"))
        with self._lock:
            tokens = list(self._sessions)
            for tok in tokens:
                pool.close(self._sessions.pop(tok).slot)

    def _execute(self, pool, ops: List[_Op]) -> None:
        now = time.monotonic()
        pushes: List[Tuple[_Op, _Session]] = []
        finishes: List[Tuple[_Op, str, _Session]] = []

        for op in ops:
            if op.kind == "open":
                try:
                    slot = pool.open()
                except RuntimeError as e:
                    op.future.set_exception(e)
                    continue
                token = uuid.uuid4().hex[:16]
                with self._lock:
                    self._sessions[token] = _Session(slot)
                    self._counters["opened"] += 1
                op.future.set_result(token)
                continue
            with self._lock:
                sess = self._sessions.get(op.token)
            if sess is None:
                op.future.set_exception(
                    KeyError(f"unknown or expired stream {op.token!r}"))
                continue
            sess.last_active = now
            if op.kind == "abort":
                # drop already-collected ops for this session: its slot is
                # about to close, and pushing a closed slot would poison
                # the whole batch's step
                gone = KeyError(f"stream {op.token!r} was aborted")
                for p, s in [x for x in pushes if x[1] is sess]:
                    pushes.remove((p, s))
                    p.future.set_exception(gone)
                for f, t, s in [x for x in finishes if x[2] is sess]:
                    finishes.remove((f, t, s))
                    f.future.set_exception(gone)
                pool.close(sess.slot)
                with self._lock:
                    self._sessions.pop(op.token, None)
                    self._counters["aborted"] += 1
                op.future.set_result(None)
            elif op.kind == "push":
                if sess.samples + op.chunk.size > self.max_stream_samples:
                    with self._lock:
                        self._counters["rejected"] += 1
                    op.future.set_exception(ValueError(
                        "stream exceeds max_stream_seconds ("
                        f"{self.max_stream_samples / self.sample_rate:.0f}"
                        "s); finish or abort it"))
                    continue
                sess.samples += op.chunk.size
                pushes.append((op, sess))
            elif op.kind == "finish":
                if op.chunk is not None and op.chunk.size:
                    # the tail is audio like any push — same cap, same
                    # recovery (the stream stays open: retry finish
                    # without the tail, or abort)
                    if (sess.samples + op.chunk.size
                            > self.max_stream_samples):
                        with self._lock:
                            self._counters["rejected"] += 1
                        op.future.set_exception(ValueError(
                            "finish tail exceeds max_stream_seconds ("
                            f"{self.max_stream_samples / self.sample_rate:.0f}"
                            "s); finish without the tail or abort"))
                        continue
                    sess.samples += op.chunk.size
                finishes.append((op, op.token, sess))
            else:  # pragma: no cover - _Op kinds are internal
                op.future.set_exception(
                    ValueError(f"unknown op {op.kind!r}"))

        if not pushes and not finishes:
            return
        batch_ops = [p[0] for p in pushes] + [f[0] for f in finishes]
        try:
            for op, sess in pushes:
                if op.chunk.size:
                    pool.push(sess.slot, op.chunk, step=False)
            for op, _tok, sess in finishes:
                if op.chunk is not None and op.chunk.size:
                    pool.push(sess.slot, op.chunk, step=False)
            final_slots = frozenset(s.slot for _, _, s in finishes)
            # ONE batched step drains every pushed slot; the final ones
            # flush their tails inside the same device passes — exactly
            # StreamPool.finalize's body, grouped across streams
            pool.step(final_slots=final_slots)
            need_partials = bool(finishes) or any(
                op.want_partial for op, _ in pushes)
            hyps = pool.partials() if need_partials else {}
            with self._lock:
                self._counters["pushes"] += len(pushes)
                self._counters["rounds"] += 1
            for op, sess in pushes:
                op.future.set_result(hyps[sess.slot] if op.want_partial
                                     else None)
            for op, token, sess in finishes:
                result = hyps[sess.slot]
                try:
                    pool.close(sess.slot)
                except KeyError:
                    pass  # double-finish in one batch: first close wins
                with self._lock:
                    self._sessions.pop(token, None)
                    self._counters["finished"] += 1
                op.future.set_result(result)
        except Exception as e:  # resolve rather than wedge the callers
            for op in batch_ops:
                if not op.future.done():
                    op.future.set_exception(e)

    def _sweep(self, pool) -> None:
        if not self.idle_timeout_s:
            return
        cutoff = time.monotonic() - self.idle_timeout_s
        with self._lock:
            stale = [(tok, s) for tok, s in self._sessions.items()
                     if s.last_active < cutoff]
            for tok, _ in stale:
                self._sessions.pop(tok, None)
            self._counters["expired"] += len(stale)
        for _tok, s in stale:
            pool.close(s.slot)
