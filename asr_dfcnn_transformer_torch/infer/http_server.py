"""HTTP serving front end: recognition over the network (the port of
``infer/http_server.py``).

A small, dependency-free HTTP server (the standard library's
``http.server``) that accepts PCM WAV request bodies and returns
recognition JSON, backed by either

- a **live** :class:`~.pipeline.Pipeline`, wrapped in
  :class:`~.serving.BatchingServer`, so concurrent requests are coalesced
  into length-bucketed device batches, or
- a **serving artifact** (:func:`~.export_serving.load_artifact`): the
  deployment where no model code or checkpoints exist on the serving
  host; its entry points pad and chunk internally.

Endpoints
---------
- ``POST /v1/recognize`` — body = a PCM WAV file (any Content-Type), or
  raw little-endian float32 mono samples with
  ``Content-Type: application/octet-stream`` (taken as 16 kHz). Response:
  ``{"pinyin": [...], "hanzi": "...", "seconds": ...}`` (e2e artifacts
  have no pinyin stage and return hanzi only).
- ``GET /healthz`` — liveness and the backend's kind.
- ``GET /v1/stats`` — request / batch / occupancy counters (and the
  stream session counters when streaming is on).

Streaming (live backend only, with ``streams > 0`` / ``serve --streams
N``; backed by :class:`~.stream_sessions.StreamSessionManager` over a
batched :class:`~.stream_pool.StreamPool`, so N concurrent streams share
one device call per stage):

- ``POST /v1/stream`` — open a stream; ``{"stream": "<token>"}``. 503 when
  all slots are busy.
- ``POST /v1/stream/<token>`` — push one chunk of raw little-endian
  float32 mono samples; returns the current partial hypothesis
  ``{"pinyin": [...], "hanzi": "...", "final": false}``. ``?partial=0``
  skips the hypothesis refresh (``{"ok": true}``).
- ``POST /v1/stream/<token>/finish`` — optional trailing chunk body;
  flushes the tail, frees the slot, returns the final hypothesis with
  ``"final": true``.
- ``DELETE /v1/stream/<token>`` — abort without decoding the tail.

Threading: handler threads block on the batching future; the device work
stays on the BatchingServer's (and the session manager's) single
dispatcher thread (live), or runs under a lock (artifact: calls are
serialised to keep single-request latency predictable on one card).
"""

from __future__ import annotations

import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import List, Optional, Sequence, Tuple

import numpy as np

from asr_dfcnn_transformer_torch.audio.wav import read_wav_bytes

__all__ = ["HTTPRecognitionServer"]

_MAX_BODY = 64 * 1024 * 1024  # 64 MiB ≈ 35 min of 16 kHz int16 — plenty


class _Server(ThreadingHTTPServer):
    # the standard library's listen backlog is 5: a burst of more
    # concurrent connections has its extra SYNs dropped and retried a
    # second later, which shows up as a second of request latency
    request_queue_size = 128


class _LiveBackend:
    """Micro-batching over a live Pipeline."""

    kind = "live"

    def __init__(self, pipeline, max_batch: int, max_wait_ms: float,
                 bucket_bounds: Sequence[int]):
        from asr_dfcnn_transformer_torch.infer.serving import BatchingServer
        self._srv = BatchingServer(pipeline, max_batch=max_batch,
                                   max_wait_ms=max_wait_ms,
                                   bucket_bounds=bucket_bounds)

    def recognize(self, signal: np.ndarray) -> Tuple[Optional[List[str]],
                                                     str]:
        return self._srv.submit(signal).result()

    def stats(self) -> dict:
        s = self._srv.stats
        return {"requests": s.requests, "batches": s.batches,
                "rows_run": s.rows_run,
                "mean_occupancy": round(s.mean_occupancy, 4),
                "per_bucket": {str(k): v for k, v in s.per_bucket.items()}}

    def close(self):
        self._srv.close()


class _ArtifactBackend:
    """Single-request path over a serving artifact."""

    def __init__(self, served):
        from asr_dfcnn_transformer_torch.infer.export_serving import (
            E2EServing)
        self._served = served
        self._e2e = isinstance(served, E2EServing)
        self.kind = "artifact-e2e" if self._e2e else "artifact"
        self._lock = threading.Lock()
        self._requests = 0

    def recognize(self, signal: np.ndarray) -> Tuple[Optional[List[str]],
                                                     str]:
        with self._lock:
            self._requests += 1
            if self._e2e:
                return None, self._served.recognize_signal(signal)
            pinyin, hanzi = self._served.recognize_signal(signal)
            return list(pinyin), hanzi

    def stats(self) -> dict:
        return {"requests": self._requests}

    def close(self):
        pass


class HTTPRecognitionServer:
    """Serve recognition over HTTP (see module docstring).

    Args:
      backend: a live ``Pipeline``, or any artifact returned by
        ``load_artifact`` (``ServingPipeline`` / ``E2EServing``).
      host/port: bind address; ``port=0`` picks a free port (see
        :attr:`port` after construction).
      max_batch / max_wait_ms / bucket_bounds: live-backend batching
        knobs, forwarded to :class:`BatchingServer`.
      sample_rate: expected input rate; wav bodies with a different rate
        are rejected 400 (the fbank front end is rate-specific,
        wav_util.py:22-31 assumes 16 kHz).
      streams: max concurrent streaming sessions (0 disables the
        ``/v1/stream`` routes). Live backend only.
      stream_kw: forwarded to :class:`StreamSessionManager` (decode,
        beam_width, idle_timeout_s, chunk_logits, ...).
    """

    def __init__(self, backend, host: str = "127.0.0.1", port: int = 0,
                 max_batch: int = 16, max_wait_ms: float = 5.0,
                 bucket_bounds: Sequence[int] = (400, 800, 1200, 1600),
                 sample_rate: int = 16000, streams: int = 0,
                 stream_kw: Optional[dict] = None):
        from asr_dfcnn_transformer_torch.infer.pipeline import Pipeline
        self._streams: Optional["StreamSessionManager"] = None
        if isinstance(backend, Pipeline):
            self._backend = _LiveBackend(backend, max_batch, max_wait_ms,
                                         bucket_bounds)
            if streams > 0:
                from asr_dfcnn_transformer_torch.infer.stream_sessions \
                    import StreamSessionManager
                self._streams = StreamSessionManager(
                    backend, n_slots=streams, sample_rate=sample_rate,
                    **(stream_kw or {}))
        else:
            if streams > 0:
                raise ValueError("streaming requires a live Pipeline "
                                 "backend (artifacts serve whole "
                                 "utterances)")
            self._backend = _ArtifactBackend(backend)
        self.sample_rate = sample_rate
        self._requests_served = 0
        self._requests_lock = threading.Lock()

        server = self

        class Handler(BaseHTTPRequestHandler):
            # quiet per-request stderr lines; errors still surface as
            # HTTP statuses
            def log_message(self, fmt, *a):
                pass

            def _reply(self, code: int, payload: dict):
                body = json.dumps(payload, ensure_ascii=False).encode()
                self.send_response(code)
                self.send_header("Content-Type",
                                 "application/json; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/healthz":
                    self._reply(200, {"status": "ok",
                                      "backend": server._backend.kind,
                                      "streaming": server._streams
                                      is not None})
                elif self.path == "/v1/stats":
                    out = server._backend.stats()
                    if server._streams is not None:
                        out["streams"] = server._streams.stats()
                    self._reply(200, out)
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def _read_body(self) -> Optional[bytes]:
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                except ValueError:
                    length = 0
                if length < 0 or length > _MAX_BODY:
                    self._reply(400, {"error": "missing or oversized "
                                               "body"})
                    return None
                return self.rfile.read(length) if length else b""

            def _stream_chunk(self, body: bytes) -> Optional[np.ndarray]:
                """Stream-push bodies are ALWAYS raw <f4 samples — a wav
                container makes no sense mid-stream."""
                if len(body) % 4:
                    self._reply(400, {"error": "stream chunks are raw "
                                               "little-endian float32 "
                                               "samples"})
                    return None
                return np.frombuffer(body, dtype="<f4").astype(np.float32)

            def _do_stream(self, parts: list):
                mgr = server._streams
                if mgr is None:
                    self._reply(404, {"error": "streaming disabled; "
                                               "start with streams > 0"})
                    return
                body = self._read_body()
                if body is None:
                    return
                try:
                    if not parts:                      # POST /v1/stream
                        if body:
                            self._reply(400, {"error": "open takes no "
                                                       "body"})
                            return
                        self._reply(200, {"stream": mgr.open()})
                        return
                    token = parts[0]
                    if len(parts) == 1:                # .../<token>
                        chunk = self._stream_chunk(body)
                        if chunk is None:
                            return
                        want = "partial=0" not in (self.path.split("?", 1)
                                                   + [""])[1]
                        hyp = mgr.push(token, chunk, want_partial=want)
                        if hyp is None:
                            self._reply(200, {"ok": True})
                        else:
                            self._reply(200, {"pinyin": hyp[0],
                                              "hanzi": hyp[1],
                                              "final": False})
                        return
                    if len(parts) == 2 and parts[1] == "finish":
                        tail = self._stream_chunk(body) if body else None
                        if body and tail is None:
                            return
                        pny, han = mgr.finish(token, tail)
                        self._reply(200, {"pinyin": pny, "hanzi": han,
                                          "final": True})
                        return
                    self._reply(404, {"error": f"no route {self.path}"})
                except KeyError as e:
                    self._reply(404, {"error": str(e.args[0]) if e.args
                                      else "unknown stream"})
                except RuntimeError as e:   # all slots busy / closed
                    self._reply(503, {"error": str(e)})
                except ValueError as e:     # over max_stream_seconds
                    self._reply(400, {"error": str(e)})
                except Exception as e:
                    self._reply(500, {"error": f"{type(e).__name__}: "
                                               f"{e}"})

            def do_DELETE(self):
                path = self.path.split("?", 1)[0]
                parts = [p for p in path.split("/") if p]
                if (len(parts) == 3 and parts[:2] == ["v1", "stream"]
                        and server._streams is not None):
                    try:
                        server._streams.abort(parts[2])
                        self._reply(200, {"ok": True})
                    except KeyError as e:
                        self._reply(404, {"error": str(e.args[0])})
                    return
                self._reply(404, {"error": f"no route {self.path}"})

            def do_POST(self):
                path = self.path.split("?", 1)[0]
                if path == "/v1/stream" or path.startswith("/v1/stream/"):
                    parts = [p for p in path.split("/") if p][2:]
                    self._do_stream(parts)
                    return
                if path != "/v1/recognize":
                    self._reply(404, {"error": f"no route {self.path}"})
                    return
                try:
                    length = int(self.headers.get("Content-Length", "0"))
                except ValueError:
                    length = 0
                if length <= 0 or length > _MAX_BODY:
                    self._reply(400, {"error": "missing or oversized body"})
                    return
                body = self.rfile.read(length)
                ctype = (self.headers.get("Content-Type") or "").lower()
                try:
                    if ctype.startswith("application/octet-stream"):
                        sig = np.frombuffer(body, dtype="<f4").astype(
                            np.float32)
                        rate = server.sample_rate
                    else:
                        sig, rate = read_wav_bytes(body)
                except Exception:
                    self._reply(400, {"error": "body is neither a PCM wav "
                                               "nor float32 samples"})
                    return
                if rate != server.sample_rate:
                    self._reply(400, {"error": f"sample rate {rate} != "
                                               f"{server.sample_rate}"})
                    return
                if sig.size == 0:
                    self._reply(400, {"error": "empty signal"})
                    return
                try:
                    pinyin, hanzi = server._backend.recognize(sig)
                except Exception as e:
                    self._reply(500, {"error": f"{type(e).__name__}: {e}"})
                    return
                with server._requests_lock:
                    server._requests_served += 1
                out = {"hanzi": hanzi,
                       "seconds": round(sig.size / rate, 3)}
                if pinyin is not None:
                    out["pinyin"] = pinyin
                self._reply(200, out)

        self._httpd = _Server((host, port), Handler)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def port(self) -> int:
        return self._httpd.server_address[1]

    @property
    def requests_served(self) -> int:
        return self._requests_served

    def start(self):
        """Serve in a background thread (returns immediately)."""
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._httpd.serve_forever,
                name="asr-http-server", daemon=True)
            self._thread.start()
        return self

    def serve_forever(self):
        """Serve on the calling thread until :meth:`close` (CLI path)."""
        self._httpd.serve_forever()

    def close(self):
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        if self._streams is not None:
            self._streams.close()
        self._backend.close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()
