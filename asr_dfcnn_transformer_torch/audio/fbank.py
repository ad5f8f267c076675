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
CPU. The numpy helpers below build their constant bases. The
single-utterance functions (``logfbank``, ``cmvn``,
``compute_fbank_from_signal``) run the same kernels at B = 1; the
reference's two spectrogram extractors take ``torch.fft.fft``.
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


# ---- single utterances (audio/fbank.py:137-300) --------------------------

def logfbank(signal: torch.Tensor,
             cfg: FbankConfig = FbankConfig()) -> torch.Tensor:
    """[S] float signal -> [num_frames(S), nfilt] f32 log mel-filterbank
    energies (``python_speech_features.logfbank``, wav_util.py:29): the
    ``log_mel`` kernel at B = 1."""
    from asr_dfcnn_transformer_torch.kernels import fbank as kfb
    signal = torch.as_tensor(signal)
    s = signal.shape[0]
    length = torch.full((1,), s, dtype=torch.int32, device=signal.device)
    return kfb.log_mel(signal.to(torch.float32).reshape(1, s).contiguous(),
                       length, num_frames(s, cfg), cfg=cfg)[0]


def cmvn(feat: torch.Tensor,
         valid_frames: Optional[int] = None) -> torch.Tensor:
    """Per-utterance, per-bin standardisation of [T, F] features
    (``sklearn.preprocessing.scale``, wav_util.py:30): zero mean, unit std
    (ddof 0, std 0 -> 1), then re-centred; the ``cmvn`` kernel at B = 1.

    ``valid_frames``: the statistics run over ``feat[:valid_frames]`` only
    (divided by max(valid_frames, 1)) and the rows from there on are
    zeroed; None takes every row."""
    from asr_dfcnn_transformer_torch.kernels import fbank as kfb
    t = feat.shape[0]
    valid = torch.full((1,), t if valid_frames is None else int(valid_frames),
                       dtype=torch.int32, device=feat.device)
    return kfb.cmvn(feat.to(torch.float32)[None].contiguous(), valid)[0]


def compute_fbank_from_signal(signal: torch.Tensor,
                              cfg: FbankConfig = FbankConfig()
                              ) -> torch.Tensor:
    """Single-utterance feature, logfbank + scale (wav_util.py:22-31):
    [S] -> [num_frames(S), nfilt], through :func:`batched_fbank` at B = 1
    (``log_mel`` then ``cmvn``)."""
    signal = torch.as_tensor(signal)
    s = signal.shape[0]
    # num_frames(S) rows, every one valid (tests/test_torch_fbank_single.py)
    feats, _ = batched_fbank(
        signal.reshape(1, s),
        torch.full((1,), s, dtype=torch.int32, device=signal.device), cfg)
    return feats[0]


def _hamming_frames(signal: torch.Tensor, n: int) -> torch.Tensor:
    """The raw signal's n Hamming-windowed frames of 400 at hop 160, zero
    past its end: [n, 400] f32."""
    ham = torch.from_numpy((0.54 - 0.46 * np.cos(
        2 * np.pi * np.arange(400) / 399)).astype(np.float32))
    raw = torch.as_tensor(signal).to(torch.float32)
    pad_len = (n - 1) * 160 + 400
    sig = torch.nn.functional.pad(raw, (0, max(pad_len - raw.shape[0], 0)))
    return sig[:pad_len].unfold(0, 400, 160) * ham.to(raw.device)


def log_spectrogram(signal: torch.Tensor,
                    feature_dim: int = 200) -> torch.Tensor:
    """The reference's hand-rolled spectrogram (wav_util.py:49-79): 400-pt
    Hamming window, hop 160, |FFT(400)|[:feature_dim], log(x + 1), then
    :func:`cmvn`. As in the reference (and the JAX package), the frame
    count comes from the pre-emphasised signal's length while the RAW
    signal is windowed; ``max(1, .)`` keeps a signal shorter than one
    window at one frame. The FFT is ``torch.fft.fft`` (cuFFT on the
    card)."""
    s = torch.as_tensor(signal).shape[0]
    n = max(1, (s * 1000 // 16000 - 25) // 10 + 1)
    spec = torch.fft.fft(_hamming_frames(signal, n), dim=-1).abs()
    return cmvn(torch.log(spec[:, :feature_dim] + 1.0))


def log_spectrogram_asrt(signal: torch.Tensor,
                         feature_dim: int = 200) -> torch.Tensor:
    """The reference's third extractor (wav_util.py:82-112): the same
    Hamming spectrogram, |FFT| divided by the signal's length, log(x + 1),
    NO standardisation; the frame count floors (no + 1)."""
    s = torch.as_tensor(signal).shape[0]
    n = max(1, (s * 1000 // 16000 - 25) // 10)
    spec = torch.fft.fft(_hamming_frames(signal, n), dim=-1).abs()
    return torch.log(spec[:, :feature_dim] / s + 1.0)
