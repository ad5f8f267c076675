"""WAV file IO with no external dependencies: a copy of the JAX package's
``audio/wav.py`` (numpy and the standard library only).

The reference reads audio via ``soundfile.read`` (floats in [-1, 1],
``data_loader.py:123``) or the stdlib ``wave`` module (int16,
``wav_util.py:34-45``). This module uses stdlib ``wave`` + numpy and scales
to [-1, 1] float32, matching the soundfile convention. Note the features are
invariant to a global amplitude scale anyway: a constant multiplier shifts
the log-filterbank additively per bin and the per-utterance CMVN removes it.
"""

from __future__ import annotations

import wave

import numpy as np


def read_wav(path: str) -> tuple[np.ndarray, int]:
    """Read a PCM wav file -> (float32 mono signal in [-1, 1], sample_rate)."""
    with open(path, "rb") as f:
        return read_wav_bytes(f.read())


def read_wav_bytes(data: bytes) -> tuple[np.ndarray, int]:
    """Decode in-memory PCM wav bytes (same contract as :func:`read_wav`;
    used by the HTTP serving front-end, which receives wavs as request
    bodies rather than paths)."""
    import io

    with wave.open(io.BytesIO(data), "rb") as w:
        n_frames = w.getnframes()
        n_channels = w.getnchannels()
        rate = w.getframerate()
        width = w.getsampwidth()
        raw = w.readframes(n_frames)
    if width == 2:
        data = np.frombuffer(raw, dtype=np.int16).astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype=np.int32).astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if n_channels > 1:
        data = data.reshape(-1, n_channels).mean(axis=1)
    return data, rate


def write_wav(path: str, signal: np.ndarray, sample_rate: int = 16000) -> None:
    """Write a float [-1, 1] signal as 16-bit PCM."""
    pcm = np.clip(signal, -1.0, 1.0)
    pcm = (pcm * 32767.0).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def synth_wav(path: str, duration_s: float = 1.0, sample_rate: int = 16000,
              freq: float = 440.0, seed: int = 0) -> None:
    """Write a synthetic tone+noise wav (test/bench fixture helper)."""
    rng = np.random.default_rng(seed)
    t = np.arange(int(duration_s * sample_rate)) / sample_rate
    sig = 0.5 * np.sin(2 * np.pi * freq * t) + 0.05 * rng.standard_normal(t.shape)
    write_wav(path, sig.astype(np.float32), sample_rate)
