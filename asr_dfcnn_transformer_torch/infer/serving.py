"""Micro-batching server: the port of ``infer/serving.py:59 BatchingServer``.

Concurrent single-utterance requests queue up; one dispatcher thread
drains the queue, waiting at most ``max_wait_ms`` after the first pending
request (or launching at once when ``max_batch`` are pending), groups them
by length bucket, pads each launch to ``[max_batch, bucket samples]`` and
resolves each request's future. Only the dispatcher thread touches the
device; callers never do.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

import numpy as np

from asr_dfcnn_transformer_torch.audio.fbank import (frames_for_samples,
                                                     samples_for_frames)
from asr_dfcnn_transformer_torch.infer.pipeline import Pipeline


@dataclass
class ServerStats:
    requests: int = 0
    batches: int = 0
    rows_run: int = 0           # includes padding rows
    per_bucket: dict = field(default_factory=dict)

    @property
    def mean_occupancy(self) -> float:
        """Real requests per launched batch row (1.0 = perfectly full)."""
        return self.requests / self.rows_run if self.rows_run else 0.0


class _Request:
    __slots__ = ("signal", "future")

    def __init__(self, signal: np.ndarray):
        self.signal = signal
        self.future: "Future[Tuple[List[str], str]]" = Future()


class BatchingServer:
    """Coalesce concurrent recognize() calls into bucketed batches.

    Args:
      pipeline: a constructed :class:`Pipeline`.
      max_batch: rows per launched batch (every launch padded to this).
      max_wait_ms: how long the dispatcher waits after the first pending
        request for more to arrive.
      bucket_bounds: frame-count buckets (multiples of 8).
    """

    def __init__(self, pipeline: Pipeline, max_batch: int = 16,
                 max_wait_ms: float = 5.0,
                 bucket_bounds: Sequence[int] = (400, 800, 1200, 1600),
                 sample_rate: int = 16000):
        self.pipeline = pipeline
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1000.0
        self.bucket_bounds = tuple(sorted(bucket_bounds))
        self.sample_rate = sample_rate
        self.stats = ServerStats()
        self._queue: "queue.Queue[Optional[_Request]]" = queue.Queue()
        self._closed = False
        self._thread = threading.Thread(target=self._dispatch_loop,
                                        name="asr-batching-dispatcher",
                                        daemon=True)
        self._thread.start()

    # ---- client API ------------------------------------------------------

    def submit(self, signal: np.ndarray) -> "Future[Tuple[List[str], str]]":
        """Queue one float32 [-1, 1] utterance; resolves to
        (pinyin syllables, hanzi string)."""
        if self._closed:
            raise RuntimeError("server is closed")
        sig = np.asarray(signal, np.float32).reshape(-1)
        max_samples = samples_for_frames(self.bucket_bounds[-1])
        req = _Request(sig[:max_samples])
        self._queue.put(req)
        return req.future

    def recognize(self, signal: np.ndarray,
                  timeout: Optional[float] = None) -> Tuple[List[str], str]:
        """Blocking convenience wrapper around :meth:`submit`."""
        return self.submit(signal).result(timeout)

    def close(self, timeout: float = 30.0) -> None:
        """Drain pending work and stop the dispatcher."""
        if not self._closed:
            self._closed = True
            self._queue.put(None)
            self._thread.join(timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- dispatcher ------------------------------------------------------

    def _bucket_of(self, n_samples: int) -> int:
        frames = frames_for_samples(n_samples)
        for bound in self.bucket_bounds:
            if frames <= bound:
                return bound
        return self.bucket_bounds[-1]

    def _dispatch_loop(self) -> None:
        pending: List[_Request] = []
        stop = False
        while not (stop and not pending):
            # block for the first request, then soak up to max_wait
            if not pending and not stop:
                item = self._queue.get()
                if item is None:
                    stop = True
                else:
                    pending.append(item)
                    deadline = time.monotonic() + self.max_wait_s
            while not stop and len(pending) < self.max_batch:
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
                pending = self._launch(pending)

    def _launch(self, pending: List[_Request]) -> List[_Request]:
        """Run ONE batch for the largest-population bucket; return the
        requests left for the next cycle."""
        groups: dict = {}
        for req in pending:
            groups.setdefault(self._bucket_of(len(req.signal)), []).append(req)
        bucket = max(groups, key=lambda k: len(groups[k]))
        batch = groups[bucket][: self.max_batch]
        rest = [r for r in pending if r not in batch]

        s_max = samples_for_frames(bucket)
        rows = np.zeros((self.max_batch, s_max), np.float32)
        lens = np.full((self.max_batch,), 400, np.int32)  # harmless filler
        for i, req in enumerate(batch):
            n = min(len(req.signal), s_max)
            rows[i, :n] = req.signal[:n]
            lens[i] = max(n, 400)
        try:
            pny_ids, pny_len, han_ids = self.pipeline.recognize_batch(
                rows, lens, bucket_frames=bucket)
            for i, req in enumerate(batch):
                k = int(pny_len[i])
                pinyin = self.pipeline.av.decode(pny_ids[i][:k])
                hanzi = ""
                if han_ids is not None and self.pipeline.lv is not None:
                    hanzi = "".join(self.pipeline.lv.decode(han_ids[i][:k]))
                req.future.set_result((pinyin, hanzi))
        except Exception as e:  # resolve rather than wedge the callers
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(e)
        self.stats.requests += len(batch)
        self.stats.batches += 1
        self.stats.rows_run += self.max_batch
        self.stats.per_bucket[bucket] = self.stats.per_bucket.get(bucket,
                                                                  0) + 1
        return rest
