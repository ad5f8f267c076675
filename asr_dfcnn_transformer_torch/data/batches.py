"""``AMBatch`` and ``LMBatch``: the JAX package's batch types
(``data/loader.py:47-64``), field for field. Arrays are numpy on the host;
the trainers move them to their device; ``data/loader.py`` makes them
from a corpus.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class AMBatch:
    signals: np.ndarray          # [B, S] float32 raw audio, zero-padded
    signal_lengths: np.ndarray   # [B] int32 valid samples
    frame_lengths: np.ndarray    # [B] int32 valid fbank frames
    pinyin: np.ndarray           # [B, Lmax] int32, zero-padded
    pinyin_lengths: np.ndarray   # [B] int32
    hanzi: np.ndarray            # [B, Lmax] int32
    hanzi_lengths: np.ndarray    # [B] int32
    weights: np.ndarray          # [B] float32: 0.0 for back-filled slots
    bucket_frames: int           # static frame count of this bucket


@dataclasses.dataclass
class LMBatch:
    pinyin: np.ndarray           # [B, L] int32, zero-padded
    hanzi: np.ndarray            # [B, L] int32, zero-padded
    lengths: np.ndarray          # [B] int32
    weights: np.ndarray          # [B] float32
