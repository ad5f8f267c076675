"""Streaming / live-capture recognition: the port of ``infer/streaming.py``.

Two recognizers over a :class:`~.pipeline.Pipeline`:

- :class:`StreamingRecognizer` — the reference's record-then-decode shape
  (``lm_and_am/read_wav.py``): a ring buffer and a full re-decode on
  ``result()``.
- :class:`IncrementalRecognizer` — per-push work proportional to the new
  audio: exact incremental fbank (pre-emphasis carried across pushes,
  frames emitted once fully covered, mel + log on the ``log_mel`` kernel
  in fixed ``frame_group`` calls), group-frozen running CMVN on the host,
  the acoustic model on fixed windows with a receptive-field halo, and a
  stateful CTC decode (greedy collapse, or the prefix beam carried across
  chunks, whose step runs the ``topk_last`` kernel). For conv-only
  acoustic models (DFCNN / KerasDFCNN) the final tokens are exactly the
  offline pipeline's; SE variants see each window's squeeze statistics
  instead of the whole utterance's (the SE global average pool is not
  causal).

The host state is numpy, as in the JAX package; the four device programs
(``feature_groups``, ``am_argmax``, ``am_log_probs``, ``lm_prefix``) are
batched functions under ``torch.no_grad()`` on the pipeline's device, run
here at a batch of one and by ``infer.stream_pool`` at the pool's.
Pre-emphasis is formed on the host as the ``log_mel`` kernel forms it
(``x[i] - 0.97 x[i-1]`` in f32, the product rounded, then the
difference), and the kernel then runs at pre-emphasis 0, which passes
those samples through unchanged: streamed features equal the offline
ones. A microphone source sits behind an optional ``pyaudio`` import.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from asr_dfcnn_transformer_torch.audio.fbank import num_frames
from asr_dfcnn_transformer_torch.infer.pipeline import (Pipeline,
                                                        infer_bucket_frames)
from asr_dfcnn_transformer_torch.kernels.fbank import log_mel
from asr_dfcnn_transformer_torch.ops.ctc_decode import (
    ctc_beam_search_stream_best, ctc_beam_search_stream_init,
    ctc_beam_search_stream_step)


class StreamingRecognizer:
    def __init__(self, pipeline: Pipeline, sample_rate: int = 16000,
                 max_seconds: float = 16.0):
        self.pipeline = pipeline
        self.sample_rate = sample_rate
        self.max_samples = int(sample_rate * max_seconds)
        self._buf = np.zeros((0,), np.float32)

    def reset(self):
        self._buf = np.zeros((0,), np.float32)

    def push(self, chunk: np.ndarray):
        """Append a float32 [-1, 1] audio chunk; keeps the last
        ``max_seconds`` of audio."""
        chunk = np.asarray(chunk, np.float32).reshape(-1)
        self._buf = np.concatenate([self._buf, chunk])[-self.max_samples:]

    @property
    def buffered_seconds(self) -> float:
        return len(self._buf) / self.sample_rate

    def result(self) -> Tuple[List[str], str]:
        """Decode everything buffered -> (pinyin syllables, hanzi)."""
        if len(self._buf) < 400:
            return [], ""
        return self.pipeline.recognize_signal(self._buf)

    def run_stream(self, chunks: Iterator[np.ndarray],
                   decode_every: Optional[float] = None):
        """Consume a chunk iterator, yielding (pinyin, hanzi) partials every
        ``decode_every`` seconds of new audio (None = only final)."""
        acc = 0.0
        for chunk in chunks:
            self.push(chunk)
            acc += len(np.asarray(chunk).reshape(-1)) / self.sample_rate
            if decode_every is not None and acc >= decode_every:
                acc = 0.0
                yield self.result()
        yield self.result()


@torch.no_grad()
def feature_groups(pe: np.ndarray, cfg, device) -> np.ndarray:
    """[N, (G-1)*hop + win] pre-emphasised samples -> [N, G, nfilt] log-mel
    (the ``log_mel`` kernel at pre-emphasis 0, every row full length)."""
    x = torch.from_numpy(pe).to(device)
    n, s = x.shape
    lens = torch.full((n,), s, dtype=torch.int32, device=device)
    return log_mel(x, lens, num_frames(s, cfg),
                   dataclasses.replace(cfg, preemph=0.0)).cpu().numpy()


def _am_logits(pipeline: Pipeline, windows: np.ndarray) -> torch.Tensor:
    """The AM's logits for ALL of each window's rows: the caller keeps the
    rows it needs, so one program serves interior chunks, the clamped head
    and the end-aligned tail."""
    x = torch.from_numpy(windows).to(pipeline.device)[:, None]  # [N, 1, R, F]
    return pipeline.am_model(x)


@torch.no_grad()
def am_argmax(pipeline: Pipeline, windows: np.ndarray) -> np.ndarray:
    """[N, R, nfilt] normalised windows -> [N, R//8] argmax ids."""
    return torch.argmax(_am_logits(pipeline, windows), dim=-1).to(
        torch.int32).cpu().numpy()


@torch.no_grad()
def am_log_probs(pipeline: Pipeline, windows: np.ndarray) -> torch.Tensor:
    """[N, R, nfilt] -> [N, R//8, V] f32 log-probs on the device (the
    beam)."""
    return torch.log_softmax(_am_logits(pipeline, windows).float(), dim=-1)


@torch.no_grad()
def lm_prefix(pipeline: Pipeline, ids: np.ndarray, lens: np.ndarray
              ) -> np.ndarray:
    """[N, cap] pinyin ids, [N] prefix lengths -> [N, cap] hanzi ids, 0
    past each prefix."""
    dev = pipeline.device
    x = torch.from_numpy(ids.astype(np.int64)).to(dev)
    han = torch.argmax(pipeline.lm_model(x), dim=-1).to(torch.int32)
    n = torch.from_numpy(lens).to(dev)
    pos = torch.arange(ids.shape[1], device=dev)
    return torch.where(pos[None, :] < n[:, None], han, 0).cpu().numpy()


class IncrementalRecognizer:
    """Incremental streaming decode: ``push()`` audio, read ``partial()``
    any time; per-push work is proportional to the new audio only.

    Stages, each stateful across pushes:

    1. **Fbank** — pre-emphasis continues across push boundaries (the last
       raw sample is carried), frames are emitted once their 400-sample
       window is fully covered, and mel + log runs in fixed
       ``frame_group``-frame calls of the ``log_mel`` kernel.
    2. **CMVN** — ``cmvn='running'`` updates per-bin mean/std (f64 on the
       host) with each completed frame group and normalises that group
       with the updated statistics; past groups stay frozen, so results
       do not depend on how the audio was chunked. ``cmvn='global'`` takes
       precomputed (mean, std); ``cmvn='none'`` feeds raw log-mel.
    3. **Encoder** — once a full ``[halo | 8*chunk_logits | halo]``-frame
       window of normalised frames exists, the AM runs on it and the
       chunk's logit rows are kept. The head window clamps to start at
       frame 0 and the finalize tail window aligns to end at the offline
       bucket edge, so the streamed program edges coincide with the
       offline program's (a conv's SAME boundary is not the same as
       explicit zero rows).
    4. **CTC** — greedy collapse with the previous frame's argmax carried,
       or the prefix beam state carried across chunks
       (``ops.ctc_beam_search_stream_step``).

    ``partial()`` / ``finalize()`` run the LM on the current pinyin prefix
    and return (pinyin, hanzi) like ``Pipeline.recognize_signal``.
    """

    def __init__(self, pipeline: Pipeline, *, chunk_logits: int = 16,
                 halo_frames: int = 64, frame_group: int = 128,
                 cmvn: str = "running",
                 global_stats: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 max_logits: int = 200, decode: Optional[str] = None,
                 beam_width: Optional[int] = None):
        if halo_frames % 8:
            raise ValueError("halo_frames must be a multiple of 8")
        if chunk_logits <= 0:
            raise ValueError("chunk_logits must be positive")
        if cmvn not in ("running", "global", "none"):
            raise ValueError(f"unknown cmvn mode {cmvn!r}")
        if cmvn == "global" and global_stats is None:
            raise ValueError("cmvn='global' needs global_stats=(mean, std)")
        self.pipeline = pipeline
        self.decode = decode if decode is not None else pipeline.decode
        if self.decode not in ("greedy", "beam"):
            raise ValueError(f"unknown decode {self.decode!r}")
        self.beam_width = beam_width or pipeline.beam_width
        self.cfg = pipeline.fbank_cfg
        self.nfilt = self.cfg.nfilt
        self.chunk_logits = chunk_logits
        self.halo = halo_frames
        self.frame_group = frame_group
        self.cmvn_mode = cmvn
        self.max_logits = max_logits
        if global_stats is not None:
            m, s = global_stats
            self._gmean = np.asarray(m, np.float32).reshape(1, -1)
            s = np.asarray(s, np.float32).reshape(1, -1)
            self._gstd = np.where(s == 0.0, 1.0, s)
        self._window_frames = 2 * self.halo + 8 * self.chunk_logits
        self._lm_cap = self.pipeline.lm_max_len
        # the CTC blank is the AM's last logit (acoustic_model.py:76)
        self._blank = pipeline.am_model.config.vocab_size - 1
        self.reset()

    # -- state ---------------------------------------------------------

    def reset(self):
        self._pe_tail = np.zeros((0,), np.float32)   # pre-emphasised, unframed
        self._last_raw: Optional[np.float32] = None
        self._n_samples = 0
        self._frames_done = 0                        # completed feature frames
        self._feats = np.zeros((0, self.nfilt), np.float32)  # normalised
        self._raw_group = np.zeros((0, self.nfilt), np.float32)
        self._stat_n = 0
        self._stat_sum = np.zeros((self.nfilt,), np.float64)
        self._stat_sq = np.zeros((self.nfilt,), np.float64)
        self._logits_done = 0
        self._ids: List[int] = []
        self._carry_id = -1                          # previous frame's argmax
        if self.decode == "beam":
            self._beam_state = ctc_beam_search_stream_init(
                1, self.beam_width, self._lm_cap, device=self.pipeline.device)

    # -- internals -----------------------------------------------------

    def _normalize(self, group: np.ndarray) -> np.ndarray:
        if self.cmvn_mode == "none":
            return group
        if self.cmvn_mode == "global":
            return (group - self._gmean) / self._gstd
        self._stat_n += group.shape[0]
        self._stat_sum += group.sum(axis=0)
        self._stat_sq += (group.astype(np.float64) ** 2).sum(axis=0)
        mean = self._stat_sum / self._stat_n
        var = np.maximum(self._stat_sq / self._stat_n - mean * mean, 0.0)
        std = np.sqrt(var)
        std = np.where(std == 0.0, 1.0, std)
        return ((group - mean) / std).astype(np.float32)

    # The feature stage is split into pool-drivable hooks: `_feat_take*`
    # pop pre-emphasised sample segments (host state only), the caller
    # runs mel + log on them (`feature_groups` at a batch of one here, at
    # the pool's batch in infer.stream_pool), `_feat_put` appends the
    # raw rows and normalises completed groups. Group boundaries, and so
    # the running-CMVN statistics, depend only on frame counts.

    def _feat_take(self) -> Optional[np.ndarray]:
        """Pop the next full frame-group sample segment, or None."""
        cfg, g = self.cfg, self.frame_group
        need = (g - 1) * cfg.hop + cfg.win_len
        if len(self._pe_tail) < need:
            return None
        seg = self._pe_tail[:need]
        self._pe_tail = self._pe_tail[g * cfg.hop:]
        self._frames_done += g
        return seg

    def _feat_take_final(self) -> Optional[Tuple[np.ndarray, int]]:
        """Pop the zero-padded tail segment and its true row count, or
        None when the stream already ended on a group boundary. Call only
        after `_feat_take` returns None."""
        cfg, g = self.cfg, self.frame_group
        need = (g - 1) * cfg.hop + cfg.win_len
        total = num_frames(self._n_samples, cfg)
        rem = total - self._frames_done
        if rem <= 0:
            self._pe_tail = np.zeros((0,), np.float32)
            return None
        pad = np.zeros((need,), np.float32)
        pad[: len(self._pe_tail)] = self._pe_tail
        self._pe_tail = np.zeros((0,), np.float32)
        self._frames_done = total
        return pad, rem

    def _feat_put(self, feats: np.ndarray, *, final: bool = False):
        """Append raw log-mel rows; normalise completed groups (all
        remaining rows when ``final``)."""
        g = self.frame_group
        if feats.shape[0]:
            self._raw_group = np.concatenate([self._raw_group, feats])
        while self._raw_group.shape[0] >= g:
            self._feats = np.concatenate(
                [self._feats, self._normalize(self._raw_group[:g])])
            self._raw_group = self._raw_group[g:]
        if final and self._raw_group.shape[0]:
            self._feats = np.concatenate(
                [self._feats, self._normalize(self._raw_group)])
            self._raw_group = np.zeros((0, self.nfilt), np.float32)

    def _feat_group(self, seg: np.ndarray) -> np.ndarray:
        return feature_groups(seg[None], self.cfg, self.pipeline.device)[0]

    def _emit_frames(self, *, final: bool = False):
        """Run mel + log on every ready frame group; normalise and
        append."""
        while (seg := self._feat_take()) is not None:
            self._feat_put(self._feat_group(seg))
        if final:
            tail = self._feat_take_final()
            if tail is not None:
                seg, rem = tail
                self._feat_put(self._feat_group(seg)[:rem])
            self._feat_put(np.zeros((0, self.nfilt), np.float32),
                           final=True)

    def _window(self, start_frame: int, size: Optional[int] = None
                ) -> np.ndarray:
        w = size if size is not None else self._window_frames
        out = np.zeros((w, self.nfilt), np.float32)
        lo = max(start_frame, 0)
        hi = min(start_frame + w, self._feats.shape[0])
        if hi > lo:
            out[lo - start_frame: hi - start_frame] = self._feats[lo:hi]
        return out

    def _plan_chunk(self, *, final: bool = False
                    ) -> Optional[Tuple[int, int, int, int]]:
        """The next AM window to decode, or None when nothing is ready.

        Returns ``(start, win_rows, r0, n_new)``: run the AM on
        ``self._window(start, win_rows)`` and keep logit rows
        ``[r0, r0 + n_new)``. A pure read of the state: the caller (the
        single-stream loop below, or a StreamPool batching many slots'
        plans into one call) runs the device work and feeds the rows to
        ``_consume_ids`` / ``_consume_beam``.

        The start clamps at frame 0, so the utterance head shares the
        offline program's left edge; at finalize, once a centred window
        would cross the bucket edge, the last window(s) align to END at
        the bucket (the offline right edge). ``n_new <= chunk_logits``
        always: an end-aligned tail longer than one chunk is drained over
        several plans of the same window.
        """
        cl, wf = self.chunk_logits, self._window_frames
        if not final:
            # every frame of the (possibly head-clamped) window must be
            # real before decoding mid-stream
            start = max(8 * self._logits_done - self.halo, 0)
            if start + wf > self._feats.shape[0]:
                return None
            # max_logits bounds mid-stream decoding too
            n_new = min(cl, self.max_logits - self._logits_done)
            if n_new <= 0:
                return None
            return start, wf, self._logits_done - start // 8, n_new
        # the offline rule (Pipeline.recognize_signal): in_len =
        # min(frames//8 + 1, bucket_frames//8), shared through
        # infer_bucket_frames so the two cannot drift
        bucket = infer_bucket_frames(self._frames_done)
        total = min(self._frames_done // 8 + 1, bucket // 8,
                    self.max_logits)
        n_new = min(cl, total - self._logits_done)
        if n_new <= 0:
            return None
        start = max(8 * self._logits_done - self.halo, 0)
        win_rows = wf
        if start + wf > bucket:
            start = max(bucket - wf, 0)
            win_rows = min(wf, bucket)
        return start, win_rows, self._logits_done - start // 8, n_new

    def _advance(self, n_new: int):
        self._logits_done += n_new

    def _consume_ids(self, ids: np.ndarray):
        """Fold a chunk's greedy argmax rows into the collapse state."""
        self._advance(len(ids))
        for v in ids:
            v = int(v)
            if v != self._carry_id and v != self._blank \
                    and len(self._ids) < self._lm_cap:
                self._ids.append(v)
            self._carry_id = v

    def _consume_beam(self, lp: torch.Tensor):
        """Advance the prefix beam over a chunk's [1, n, V] log-probs."""
        self._beam_state = ctc_beam_search_stream_step(
            self._beam_state, lp, beam_width=self.beam_width,
            topk=self.beam_width, blank_id=-1)
        self._advance(lp.shape[1])

    def _decode_ready(self, *, final: bool = False):
        while (plan := self._plan_chunk(final=final)) is not None:
            start, win_rows, r0, n_new = plan
            window = self._window(start, win_rows)[None]
            if self.decode == "beam":
                self._consume_beam(am_log_probs(self.pipeline, window)
                                   [:, r0: r0 + n_new])
            else:
                self._consume_ids(am_argmax(self.pipeline, window)
                                  [0, r0: r0 + n_new])

    # -- public API ----------------------------------------------------

    def _buffer_push(self, chunk: np.ndarray):
        """Pre-emphasise (carrying the last raw sample across pushes) and
        buffer a non-empty float32 chunk, in f32 as the ``log_mel`` kernel
        does: the product rounded, then the difference. Host only; the
        pool calls this directly."""
        prev = np.empty_like(chunk)
        prev[1:] = chunk[:-1]
        prev[0] = 0.0 if self._last_raw is None else self._last_raw
        pe = chunk - np.float32(self.cfg.preemph) * prev
        if self._last_raw is None:
            pe[0] = chunk[0]
        self._last_raw = chunk[-1]
        self._n_samples += chunk.size
        self._pe_tail = np.concatenate([self._pe_tail, pe])

    def push(self, chunk: np.ndarray):
        chunk = np.asarray(chunk, np.float32).reshape(-1)
        if chunk.size == 0:
            return
        self._buffer_push(chunk)
        self._emit_frames()
        self._decode_ready()

    @property
    def pinyin_ids(self) -> List[int]:
        if self.decode == "beam":
            ids, lns, _ = ctc_beam_search_stream_best(self._beam_state)
            return [int(x) for x in ids[0][: int(lns[0])].cpu()]
        return list(self._ids)

    def _lm_decode(self, cur: List[int]) -> str:
        if self.pipeline.lm_model is None or not cur \
                or self.pipeline.lv is None:
            return ""
        cap = self._lm_cap
        ids = np.zeros((cap,), np.int32)
        n = min(len(cur), cap)
        ids[:n] = cur[:n]
        han = lm_prefix(self.pipeline, ids[None],
                        np.array([n], np.int32))[0, :n]
        return "".join(self.pipeline.lv.decode(list(han)))

    def partial(self) -> Tuple[List[str], str]:
        """Current hypothesis; costs one LM pass over the prefix."""
        cur = self.pinyin_ids
        return self.pipeline.av.decode(cur), self._lm_decode(cur)

    def finalize(self) -> Tuple[List[str], str]:
        """Flush tail frames / logits and return the final hypothesis."""
        self._emit_frames(final=True)
        self._decode_ready(final=True)
        return self.partial()


def microphone_chunks(seconds: float = 16.0, sample_rate: int = 16000,
                      chunk_size: int = 1024):
    """Optional pyaudio microphone source (read_wav.py:14-43 capability).
    Raises ImportError with guidance when pyaudio is absent."""
    try:
        import pyaudio  # type: ignore
    except ImportError as e:
        raise ImportError(
            "pyaudio is not installed; feed StreamingRecognizer.push() from "
            "your own audio source instead") from e
    pa = pyaudio.PyAudio()
    stream = pa.open(format=pyaudio.paInt16, channels=1, rate=sample_rate,
                     input=True, frames_per_buffer=chunk_size)
    try:
        n_chunks = int(seconds * sample_rate / chunk_size)
        for _ in range(n_chunks):
            raw = stream.read(chunk_size)
            yield np.frombuffer(raw, np.int16).astype(np.float32) / 32768.0
    finally:
        stream.stop_stream()
        stream.close()
        pa.terminate()
