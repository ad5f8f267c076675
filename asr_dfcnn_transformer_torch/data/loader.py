"""Batch data loaders with length bucketing and threaded prefetch: the port
of the JAX package's ``data/loader.py`` (``DataLoader``, ``prefetch``), on
numpy and the standard library. It yields the port's ``data/batches.py``
``AMBatch`` / ``LMBatch``, the same arrays for the same manifest, as the
JAX loader gives them (wav headers and samples through the native decoder,
``data/native_loader.py``).

- **Raw signals to the device**: batches carry padded raw audio and
  lengths; the log-filterbank front end runs inside the train and infer
  steps (``audio.batched_fbank``).
- **Length bucketing**: each batch is padded to a bucket's shape (default
  frame bounds 400/800/1200/1600) instead of always [B, 1600, 200, 1].
- **Row-drop semantics preserved**: utterances are dropped when OOV, when
  frames > feature_max_length, when label length > 64, or when
  label_len >= CTC input length min(200, frames//8+1)
  (data_loader.py:132-144). Dropped slots are back-filled by repeating
  valid rows with weight 0, so a batch's shape does not depend on the data.
- **Clean root first, then the noise root** (``noise_root``, where
  ``audio/noise_corpus.py`` writes its corpus; data_loader.py:120-127).
- **Threaded prefetch** replaces tf.data's generator wrapper.

LM batches mirror ``get_lm_batch`` (data_loader.py:164-193): dynamic
per-batch max length, rounded up to a small set of length buckets.
"""

from __future__ import annotations

import os
import queue
import threading
from typing import Iterator, List, Optional, Sequence

import numpy as np

from asr_dfcnn_transformer_torch.audio.fbank import (frames_for_samples,
                                                     samples_for_frames)
from asr_dfcnn_transformer_torch.audio.wav import read_wav
from asr_dfcnn_transformer_torch.core import constants
from asr_dfcnn_transformer_torch.data import native_loader
from asr_dfcnn_transformer_torch.core.vocab import (Vocab, hanzi_to_ids,
                                                    pinyin_to_ids)
from asr_dfcnn_transformer_torch.data.batches import AMBatch, LMBatch
from asr_dfcnn_transformer_torch.data.manifest import Manifest


class DataLoader:
    """Manifest -> static-shape batches.

    Args mirror the knobs of the reference DataLoader (data_loader.py:20-41)
    plus bucketing.
    """

    def __init__(self, manifest: Manifest, acoustic_vocab: Vocab,
                 language_vocab: Vocab,
                 speech_root: str = "",
                 noise_root: str = "",
                 feature_max_length: int = constants.FEATURE_MAX_LENGTH,
                 max_label_length: int = constants.MAX_LABEL_LENGTH,
                 max_logit_length: int = 200,
                 bucket_bounds: Sequence[int] = (400, 800, 1200, 1600)):
        self.manifest = manifest
        self.av = acoustic_vocab
        self.lv = language_vocab
        self.speech_root = speech_root
        self.noise_root = noise_root
        self.max_label_length = max_label_length
        self.max_logit_length = max_logit_length
        self.bucket_bounds = tuple(sorted(bucket_bounds))
        # the largest bucket is a hard length limit: rows beyond it are
        # DROPPED by the row filter (the documented drop-row semantics),
        # never silently truncated to the bucket while keeping their full
        # transcript at weight 1.0
        self.feature_max_length = min(feature_max_length,
                                      self.bucket_bounds[-1])

    # ---------- path & row handling ----------

    def _resolve(self, rel_path: str) -> Optional[str]:
        """Clean-corpus path first, noise-corpus fallback
        (data_loader.py:120-127)."""
        for root in (self.speech_root, self.noise_root):
            p = os.path.join(root, rel_path) if root else rel_path
            if os.path.isfile(p):
                return p
        return None

    def _encode_row(self, i: int):
        """Returns (path, pinyin_ids, hanzi_ids, n_samples, n_frames) or
        None when the row must be dropped (OOV / length rules,
        data_loader.py:132-144)."""
        try:
            pny = pinyin_to_ids(self.av, self.manifest.pinyin[i])
            han = hanzi_to_ids(self.lv, self.manifest.hanzi[i])
        except ValueError:
            return None
        path = self._resolve(self.manifest.paths[i])
        if path is None:
            return None
        try:
            n_samples = native_loader.probe(path)[0]
        except OSError:
            # unparseable/truncated wav: drop the row like every other
            # bad-row condition instead of aborting the epoch
            return None
        n_frames = frames_for_samples(n_samples)
        input_len = min(self.max_logit_length, n_frames // 8 + 1)
        if n_frames > self.feature_max_length:
            return None
        if len(pny) > self.max_label_length or len(pny) >= input_len:
            return None
        if len(han) > self.max_label_length:
            return None
        return path, pny, han, n_samples, n_frames

    def _bucket_of(self, n_frames: int) -> int:
        for b in self.bucket_bounds:
            if n_frames <= b:
                return b
        return self.bucket_bounds[-1]

    # ---------- AM batches ----------

    def am_batches(self, batch_size: int, shuffle: bool = True,
                   seed: int = 0) -> Iterator[AMBatch]:
        """Yield static-shape AM batches grouped by length bucket."""
        order = np.arange(len(self.manifest))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        buckets: dict = {b: [] for b in self.bucket_bounds}
        for i in order:
            row = self._encode_row(int(i))
            if row is None:
                continue
            buckets[self._bucket_of(row[4])].append(row)
            for b, rows in buckets.items():
                if len(rows) == batch_size:
                    yield self._assemble_am(rows, b)
                    buckets[b] = []
        # trailing partial batches: back-fill with repeats, weight 0
        for b, rows in buckets.items():
            if rows:
                yield self._assemble_am(rows, b, pad_to=batch_size)

    def _assemble_am(self, rows: List, bucket_frames: int,
                     pad_to: Optional[int] = None) -> AMBatch:
        n_valid = len(rows)
        bsz = pad_to or n_valid
        s_max = samples_for_frames(bucket_frames)
        l_max = self.max_label_length
        signals = np.zeros((bsz, s_max), np.float32)
        sig_len = np.zeros((bsz,), np.int32)
        frm_len = np.zeros((bsz,), np.int32)
        pny = np.zeros((bsz, l_max), np.int32)
        pny_len = np.zeros((bsz,), np.int32)
        han = np.zeros((bsz, l_max), np.int32)
        han_len = np.zeros((bsz,), np.int32)
        weights = np.zeros((bsz,), np.float32)
        paths = [rows[j % n_valid][0] for j in range(bsz)]
        signals, dec_len = native_loader.decode_batch(paths, s_max,
                                                      out=signals)
        for j in range(bsz):
            path, p_ids, h_ids, n_samp, n_frm = rows[j % n_valid]
            sig_len[j] = max(int(dec_len[j]), 0)
            frm_len[j] = min(n_frm, bucket_frames)
            pny[j, : len(p_ids)] = p_ids
            pny_len[j] = len(p_ids)
            han[j, : len(h_ids)] = h_ids
            han_len[j] = len(h_ids)
            weights[j] = 1.0 if (j < n_valid and dec_len[j] >= 0) else 0.0
        return AMBatch(signals, sig_len, frm_len, pny, pny_len, han, han_len,
                       weights, bucket_frames)

    # ---------- LM batches ----------

    def lm_batches(self, batch_size: int, shuffle: bool = True, seed: int = 0,
                   length_buckets: Sequence[int] = (25, 50, 75, 100)
                   ) -> Iterator[LMBatch]:
        """Pinyin->hanzi pairs, padded to the smallest length bucket that
        fits the batch max (get_lm_batch semantics, data_loader.py:164-193;
        the hanzi sequence must align 1:1 with pinyin)."""
        order = np.arange(len(self.manifest))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        cap = max(length_buckets)
        pending = []
        for i in order:
            try:
                p_ids = pinyin_to_ids(self.av, self.manifest.pinyin[int(i)])
                h_ids = hanzi_to_ids(self.lv, self.manifest.hanzi[int(i)])
            except ValueError:
                continue
            if len(p_ids) != len(h_ids) or not p_ids or len(p_ids) > cap:
                continue
            pending.append((p_ids, h_ids))
            if len(pending) == batch_size:
                yield self._assemble_lm(pending, length_buckets)
                pending = []
        if pending:
            yield self._assemble_lm(pending, length_buckets,
                                    pad_to=batch_size)

    def _assemble_lm(self, rows: List, length_buckets: Sequence[int],
                     pad_to: Optional[int] = None) -> LMBatch:
        n_valid = len(rows)
        bsz = pad_to or n_valid
        longest = max(len(p) for p, _ in rows)
        l = next(b for b in sorted(length_buckets) if b >= longest)
        pny = np.zeros((bsz, l), np.int32)
        han = np.zeros((bsz, l), np.int32)
        lens = np.zeros((bsz,), np.int32)
        weights = np.zeros((bsz,), np.float32)
        for j in range(bsz):
            p_ids, h_ids = rows[j % n_valid]
            pny[j, : len(p_ids)] = p_ids
            han[j, : len(h_ids)] = h_ids
            lens[j] = len(p_ids)
            weights[j] = 1.0 if j < n_valid else 0.0
        return LMBatch(pny, han, lens, weights)

    # ---------- single utterance (inference path) ----------

    def load_utterance(self, index: int):
        """Single-utterance signal + labels (the get_fbank_and_pinyin_data
        capability, data_loader.py:213-244). Returns (signal float32 [S],
        pinyin_ids, hanzi string) or raises ValueError on a bad row."""
        row = self._encode_row(index)
        if row is None:
            raise ValueError(f"row {index} is invalid (OOV/length/path)")
        path, p_ids, _h_ids, _ns, _nf = row
        sig, _ = read_wav(path)
        return sig, p_ids, self.manifest.hanzi[index]


def prefetch(gen: Iterator, depth: int = 4) -> Iterator:
    """Run a generator in a daemon thread with a bounded queue — the
    replacement for tf.data's prefetch (train.py:40-42)."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    err: List[BaseException] = []
    stop = threading.Event()

    def _put(item) -> bool:
        # bounded put that gives up once the consumer is gone — a plain
        # q.put would block forever when the consumer abandons the
        # iterator mid-epoch (NaN abort, KeyboardInterrupt), pinning the
        # thread plus several decoded batches
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            for item in gen:
                if not _put(item):
                    return
        except BaseException as e:  # surfaced on the consumer side
            err.append(e)
        finally:
            _put(sentinel)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is sentinel:
                if err:
                    raise err[0]
                return
            yield item
    finally:
        stop.set()
