"""Colored-noise augmentation on the signals' device: the port of
``audio/noise.py``.

Each utterance of a [B, S] batch is mixed with its own 1/f^alpha noise
(alpha on the 0.1 grid over [-1, 1]; 0 white, < 0 red, > 0 blue) at an
integer SNR drawn from 5..10 dB, as the reference's ``util/noise.py`` does
offline. The noise is white Gaussian spectrum shaped by k^alpha, made at
n_fft = the next power of two >= S by one inverse real FFT and truncated to
S, de-meaned and divided by its signed max; its gain over each signal's
valid prefix sets the SNR, and the padding of the mixture is zeroed.

The random draws are apart from the arithmetic, as in
``audio/specaugment.py``: ``noise_draws`` takes the SNRs, the alpha grid
indices and the white half-spectra from a ``torch.Generator``;
``add_noise_from_draws`` computes what the JAX ``add_noise_batch`` computes
from them, so the tests can feed it the JAX package's own draws. One
batched ``irfft`` over [B, nbins] replaces JAX's per-row ``vmap``.

The inverse FFT is the JAX package's choice: ``ops/matfft.py``
``irfft_matmul`` in bf16 compute only on a TPU (``_use_matfft``), the FFT
everywhere else. The port runs on no TPU, so it takes ``torch.fft.irfft``
(cuFFT on the card); the matfft branch is held to the JAX one by the tests.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from asr_dfcnn_transformer_torch.ops.matfft import irfft_matmul

Draws = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


def _use_matfft() -> bool:
    """The JAX package's predicate (matfft only on a TPU): False on every
    device the port runs on."""
    return False


def fft_size(length: int) -> int:
    """The transform size: the next power of two >= length (at least 2)."""
    return 1 << max(math.ceil(math.log2(max(length, 2))), 1)


def alpha_grid_size(alpha_range: Tuple[float, float] = (-1.0, 1.0)) -> int:
    return int(round((alpha_range[1] - alpha_range[0]) / 0.1)) + 1


def noise_draws(b: int, s: int, generator: Optional[torch.Generator] = None,
                snr_db_range: Tuple[int, int] = (5, 10),
                alpha_range: Tuple[float, float] = (-1.0, 1.0),
                device=None) -> Draws:
    """The random draws of one batch of B signals of S samples, in order:
    SNRs [B] (integers in snr_db_range, inclusive), alpha grid indices [B],
    then the white half-spectra re, im [B, n_fft/2 + 1] f32 (standard
    normal). Drawn on the generator's device (``device`` without one)."""
    dev = generator.device if generator is not None else device
    nbins = fft_size(s) // 2 + 1
    snr = torch.randint(snr_db_range[0], snr_db_range[1] + 1, (b,),
                        generator=generator, device=dev)
    alpha_idx = torch.randint(0, alpha_grid_size(alpha_range), (b,),
                              generator=generator, device=dev)
    re = torch.randn((b, nbins), generator=generator, device=dev)
    im = torch.randn((b, nbins), generator=generator, device=dev)
    return snr, alpha_idx, re, im


def alpha_of(alpha_idx: torch.Tensor,
             alpha_range: Tuple[float, float] = (-1.0, 1.0)) -> torch.Tensor:
    """alpha = alpha_range[0] + 0.1 * index, in f32 as the JAX code forms
    it."""
    return alpha_range[0] + 0.1 * alpha_idx.float()


def color_noise(re: torch.Tensor, im: torch.Tensor, alpha: torch.Tensor,
                length: int) -> torch.Tensor:
    """Colored noise [B, length] f32 from white half-spectra re, im [B,
    nbins] and alpha [B]: bin i shaped by (i + 1)^alpha, one inverse real
    FFT at n_fft = 2 (nbins - 1), truncated, de-meaned, divided by the
    signed max."""
    nbins = re.shape[-1]
    n_fft = 2 * (nbins - 1)
    k = torch.arange(1, nbins + 1, dtype=torch.float32, device=re.device)
    shape_k = k[None, :] ** alpha[:, None]
    if _use_matfft() and n_fft >= 8:    # matfft's two-stage split needs 8
        # bf16 compute, "auto" epilogue: the JAX package's TPU branch
        noise = irfft_matmul(re * shape_k, im * shape_k, n_fft,
                             compute_dtype=torch.bfloat16)[..., :length]
    else:
        noise = torch.fft.irfft(torch.complex(re * shape_k, im * shape_k),
                                n=n_fft)[..., :length]
    noise = noise - noise.mean(dim=-1, keepdim=True)
    noise = noise / noise.amax(dim=-1, keepdim=True)
    return noise.float()


def snr_to_gain(signal: torch.Tensor, noise: torch.Tensor,
                snr_db: torch.Tensor,
                signal_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Noise gain K per row such that signal + K noise has ``snr_db``; with
    ``signal_len`` the signal's energy is averaged over its valid prefix.
    signal, noise [..., S]; snr_db, signal_len [...]."""
    if signal_len is None:
        es = torch.mean(signal * signal, dim=-1)
    else:
        n = signal.shape[-1]
        mask = (torch.arange(n, device=signal.device)
                < signal_len[..., None]).to(signal.dtype)
        es = torch.sum(signal * signal * mask, dim=-1) / torch.clamp_min(
            signal_len, 1)
    en = torch.mean(noise * noise, dim=-1)
    return torch.sqrt(es / torch.clamp_min(en, 1e-12)) * torch.pow(
        10.0, -snr_db / 20.0)


def add_noise_from_draws(signals: torch.Tensor,
                         lengths: Optional[torch.Tensor], draws: Draws,
                         alpha_range: Tuple[float, float] = (-1.0, 1.0)
                         ) -> torch.Tensor:
    """``add_noise_batch``'s arithmetic on given draws (moved to the
    signals' device): signals [B, S] f32, lengths [B] or None -> the
    mixtures [B, S] f32, zero past each length."""
    dev = signals.device
    snr, alpha_idx, re, im = (d.to(dev) for d in draws)
    s = signals.shape[-1]
    noise = color_noise(re, im, alpha_of(alpha_idx, alpha_range), s)
    if lengths is not None:
        lengths = lengths.to(dev)
    gain = snr_to_gain(signals, noise, snr.float(), lengths)
    mixed = signals + gain[:, None] * noise
    if lengths is not None:
        mixed = mixed * (torch.arange(s, device=dev)[None, :]
                         < lengths[:, None]).to(mixed.dtype)
    return mixed.float()


def add_noise_batch(signals: torch.Tensor,
                    lengths: Optional[torch.Tensor] = None,
                    generator: Optional[torch.Generator] = None,
                    snr_db_range: Tuple[int, int] = (5, 10),
                    alpha_range: Tuple[float, float] = (-1.0, 1.0)
                    ) -> torch.Tensor:
    """Mix every signal of a [B, S] batch with its own colored noise at a
    random SNR (draws from ``generator``, on its device)."""
    b, s = signals.shape
    draws = noise_draws(b, s, generator, snr_db_range, alpha_range,
                        device=signals.device)
    return add_noise_from_draws(signals, lengths, draws, alpha_range)
