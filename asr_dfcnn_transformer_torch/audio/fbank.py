"""Log-filterbank front end: the port of ``asr_dfcnn_transformer_tpu.audio.fbank``.

``python_speech_features.logfbank(signal, 16000, nfilt=200)`` followed by
per-utterance ``sklearn.preprocessing.scale``, as the JAX package computes
it (see its module docstring for the parity notes): pre-emphasis 0.97,
400-sample frames at hop 160 with a rectangular window, ``|rfft(512)|^2 /
512``, a triangular mel bank with integer-bin breakpoints (some of the 200
filters over 257 bins are empty), ``log(max(., f64 eps))``, then masked
per-bin standardisation.

The numerics run in two kernels (``kernels/fbank.py``): ``log_mel`` and
``cmvn``, each a CUDA kernel on the card and its plain-PyTorch twin on the
CPU. The numpy helpers below build their constant bases.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class FbankConfig:
    """The JAX package's ``FbankConfig`` field for field. The kernels are
    fixed to win 400 / hop 160 / nfft 512; ``use_dft_matmul`` and
    ``backend`` select among the JAX package's implementations and are
    kept so configs stay interchangeable — the port has one."""

    sample_rate: int = 16000
    win_len: int = 400
    hop: int = 160
    nfft: int = 512
    nfilt: int = 200
    preemph: float = 0.97
    low_freq: float = 0.0
    high_freq: Optional[float] = None  # None -> sample_rate / 2
    use_dft_matmul: bool = True
    backend: str = "auto"


def num_frames(num_samples: int, cfg: FbankConfig = FbankConfig()) -> int:
    """python_speech_features framing count: 1 + ceil((S - win) / hop)."""
    if num_samples <= cfg.win_len:
        return 1
    return 1 + int(math.ceil((num_samples - cfg.win_len) / cfg.hop))


def frames_for_samples(num_samples: int, win: int = 400,
                       hop: int = 160) -> int:
    return num_frames(num_samples, FbankConfig(win_len=win, hop=hop))


def samples_for_frames(frames: int, win: int = 400, hop: int = 160) -> int:
    return (frames - 1) * hop + win


def _hz2mel(hz):
    return 2595.0 * np.log10(1.0 + np.asarray(hz) / 700.0)


def _mel2hz(mel):
    return 700.0 * (10.0 ** (np.asarray(mel) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=8)
def _mel_filterbank_np(sample_rate: int, nfft: int, nfilt: int,
                       low_freq: float, high_freq: float) -> np.ndarray:
    """Triangular mel bank with integer-bin breakpoints, [nfft//2+1, nfilt]
    (python_speech_features.get_filterbanks, transposed)."""
    low_mel, high_mel = _hz2mel(low_freq), _hz2mel(high_freq)
    mel_points = np.linspace(low_mel, high_mel, nfilt + 2)
    bins = np.floor((nfft + 1) * _mel2hz(mel_points)
                    / sample_rate).astype(np.int64)
    bank = np.zeros((nfilt, nfft // 2 + 1), dtype=np.float64)
    for j in range(nfilt):
        for i in range(bins[j], bins[j + 1]):
            bank[j, i] = (i - bins[j]) / (bins[j + 1] - bins[j])
        for i in range(bins[j + 1], bins[j + 2]):
            bank[j, i] = (bins[j + 2] - i) / (bins[j + 2] - bins[j + 1])
    return bank.T.astype(np.float32)


def mel_filterbank(cfg: FbankConfig = FbankConfig()) -> np.ndarray:
    high = cfg.high_freq if cfg.high_freq is not None else cfg.sample_rate / 2
    return _mel_filterbank_np(cfg.sample_rate, cfg.nfft, cfg.nfilt,
                              cfg.low_freq, high)


@functools.lru_cache(maxsize=8)
def _dft_bases_np(win_len: int, nfft: int):
    """Real/imag DFT bases [win_len, nfft//2+1]: frames @ C + i frames @ S
    == rfft(frames, nfft) for frames of length win_len."""
    n = np.arange(win_len)[:, None]
    k = np.arange(nfft // 2 + 1)[None, :]
    ang = -2.0 * np.pi * n * k / nfft
    return (np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32))


def valid_frames(lengths: torch.Tensor,
                 cfg: FbankConfig = FbankConfig()) -> torch.Tensor:
    """[B] sample counts -> [B] int32 frame counts (num_frames elementwise:
    1 if S <= win else 1 + ceil((S - win) / hop))."""
    lengths = lengths.to(torch.int64)
    n = 1 + torch.div(lengths - cfg.win_len + cfg.hop - 1, cfg.hop,
                      rounding_mode="floor")
    return torch.where(lengths <= cfg.win_len, 1, n).to(torch.int32)


def batched_fbank(signals: torch.Tensor, lengths: torch.Tensor,
                  cfg: FbankConfig = FbankConfig(),
                  out_frames: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, S] padded signals + [B] sample lengths -> ([B, T, nfilt] f32
    normalised features, [B] int32 valid frame counts).

    T = num_frames(S), or ``out_frames`` when given. Rows past an
    utterance's valid frames are zero. The statistics run over ALL valid
    frames even when ``out_frames`` truncates, as in the JAX package.
    """
    from asr_dfcnn_transformer_torch.kernels import fbank as kfb

    n = num_frames(signals.shape[1], cfg)
    t_out = out_frames if out_frames is not None else n
    lengths = lengths.to(device=signals.device, dtype=torch.int32)
    valid = valid_frames(lengths, cfg)
    feat = kfb.log_mel(signals.to(torch.float32).contiguous(), lengths,
                       max(t_out, n), cfg=cfg)
    # cmvn zeroes rows past valid, so the slice needs no second mask
    feats = kfb.cmvn(feat, valid)[:, :t_out]
    return feats, torch.clamp(valid, max=t_out)
