"""The plain reference of the front end: ``python_speech_features.logfbank``
(nfilt 200) then per-utterance ``sklearn.preprocessing.scale``, as the
reference's ``wav_util.py:22-31`` computes features, batched over padded
signals.

Pre-emphasis 0.97; 400-sample frames at hop 160 with a rectangular window;
frames past the signal's end read zeros (pre-emphasis is masked there too);
``|rfft(512)|^2 / 512`` in float64; a triangular mel bank with integer-bin
breakpoints; ``log(max(., eps64))``; then over each utterance's valid
frames: mean, standard deviation (ddof 0, 0 -> 1), scale, re-centre;
rows past the valid frames are 0. Also the frame and CTC-logit counts.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

SAMPLE_RATE, WIN, HOP, NFFT, PREEMPH = 16000, 400, 160, 512, 0.97
EPS64 = float(np.finfo(np.float64).eps)


def frames_of(samples: torch.Tensor) -> torch.Tensor:
    """1 if S <= 400 else 1 + ceil((S - 400) / 160), elementwise."""
    s = samples.long()
    return torch.where(s <= WIN, 1, 1 + torch.div(s - WIN + HOP - 1, HOP,
                                                  rounding_mode="floor"))


def samples_for_frames(frames: int) -> int:
    return (frames - 1) * HOP + WIN


def logit_lengths(samples: torch.Tensor, logit_frames: int) -> torch.Tensor:
    """The CTC input length min(T', frames // 8 + 1) (data_loader.py:132)."""
    return torch.clamp(frames_of(samples) // 8 + 1, max=logit_frames)


@functools.lru_cache(maxsize=4)
def mel_bank(nfilt: int) -> np.ndarray:
    """python_speech_features.get_filterbanks(nfilt, 512, 16000), [257,
    nfilt] float64."""
    def hz2mel(hz):
        return 2595.0 * np.log10(1.0 + hz / 700.0)

    def mel2hz(mel):
        return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)

    mels = np.linspace(hz2mel(0.0), hz2mel(SAMPLE_RATE / 2), nfilt + 2)
    bins = np.floor((NFFT + 1) * mel2hz(mels) / SAMPLE_RATE).astype(int)
    bank = np.zeros((nfilt, NFFT // 2 + 1))
    for j in range(nfilt):
        lo, mid, hi = bins[j], bins[j + 1], bins[j + 2]
        for i in range(lo, mid):
            bank[j, i] = (i - lo) / (mid - lo)
        for i in range(mid, hi):
            bank[j, i] = (hi - i) / (hi - mid)
    return bank.T


def fbank(signals: torch.Tensor, lengths: torch.Tensor, frames: int,
          nfilt: int = 200) -> torch.Tensor:
    """[B, S] signals, [B] sample counts -> [B, frames, nfilt] float32
    normalised features."""
    x = signals.double()
    b, s = x.shape
    pe = torch.cat([x[:, :1], x[:, 1:] - PREEMPH * x[:, :-1]], dim=1)
    pe = pe * (torch.arange(s, device=x.device)[None] < lengths[:, None])
    need = samples_for_frames(frames)
    pe = torch.nn.functional.pad(pe, (0, max(0, need - s)))[:, :need]
    spec = torch.fft.rfft(pe.unfold(1, WIN, HOP), n=NFFT)
    power = spec.real ** 2 + spec.imag ** 2
    bank = torch.from_numpy(mel_bank(nfilt)).to(x.device)
    feat = torch.log(torch.clamp_min(power / NFFT @ bank, EPS64))
    valid = torch.clamp(frames_of(lengths), max=frames)
    mask = (torch.arange(frames, device=x.device)[None, :, None]
            < valid[:, None, None]).double()
    count = valid.double()[:, None, None]
    mean = (feat * mask).sum(1, keepdim=True) / count
    std = torch.sqrt((((feat - mean) * mask) ** 2).sum(1, keepdim=True)
                     / count)
    std = torch.where(std == 0, torch.ones_like(std), std)
    out = (feat - mean) / std
    out = out - (out * mask).sum(1, keepdim=True) / count
    return (out * mask).float()
