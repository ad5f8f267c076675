"""SpecAugment: time and frequency masking of fbank features, on the
features' device. The port of ``audio/specaugment.py``.

Every utterance draws the configured number of masks, each a band of
width 0 or more (width 0 masks nothing), so shapes never depend on the
data. Time bands stay inside an utterance's valid frames: both the width
cap (``max_time_frac`` of the valid length, adaptive) and the start are
drawn from its own frame count. ``mask_value`` 0.0 is each bin's mean
after the per-utterance CMVN.

``spec_draws`` draws four [B, M] uniform arrays from a ``torch.Generator``
(frequency widths and starts, then time widths and starts) and
``mask_features`` applies ``_rand_bands``'s arithmetic to them exactly, so
the tests can feed it the JAX package's own draws; ``spec_augment`` does
both.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class SpecAugmentConfig:
    """Masking policy (the JAX package's fields and defaults)."""

    num_freq_masks: int = 2
    max_freq_width: int = 27          # F: max mel bins per mask
    num_time_masks: int = 2
    max_time_width: int = 100         # T: absolute max frames per mask
    max_time_frac: float = 0.05       # p: adaptive cap, frac of valid len
    mask_value: float = 0.0           # post-CMVN per-bin mean


def band_mask(starts: torch.Tensor, widths: torch.Tensor,
              size: int) -> torch.Tensor:
    """[B, M] starts / widths -> [B, size] bool: True inside any band."""
    pos = torch.arange(size, device=starts.device)[None, None, :]
    s = starts[:, :, None]
    return ((pos >= s) & (pos < s + widths[:, :, None])).any(dim=1)


def rand_bands(uw: torch.Tensor, us: torch.Tensor, max_width: torch.Tensor,
               limit: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Uniform [0, 1) draws uw, us [B, M] -> (starts, widths) [B, M] int32
    with width <= max_width and each band inside [0, limit): ``max_width``
    and ``limit`` are [B, 1] int32. f32 floors, as ``_rand_bands``."""
    wmax = torch.minimum(max_width, limit)
    widths = torch.floor(uw * (wmax + 1).float()).to(torch.int32)
    widths = torch.minimum(widths, wmax)      # guard the u == 1.0 edge
    room = torch.clamp_min(limit - widths, 0)
    starts = torch.floor(us * (room + 1).float()).to(torch.int32)
    return torch.minimum(starts, room), widths


def mask_features(feats: torch.Tensor, valid_frames: Optional[torch.Tensor],
                  cfg: SpecAugmentConfig,
                  draws: Sequence[torch.Tensor]) -> torch.Tensor:
    """Apply the masks given by ``draws`` = (frequency widths, frequency
    starts, time widths, time starts), uniform [B, M] arrays for the
    configured mask counts, to feats [B, T, F] (or [B, T, F, 1])."""
    squeeze = feats.dim() == 4
    x = feats[..., 0] if squeeze else feats
    b, t, f = x.shape
    if valid_frames is None:
        valid = torch.full((b, 1), t, dtype=torch.int32, device=x.device)
    else:
        valid = torch.clamp(valid_frames.to(x.device, torch.int32).reshape(
            b, 1), 0, t)
    fill = torch.tensor(cfg.mask_value, dtype=x.dtype, device=x.device)
    fuw, fus, tuw, tus = (u.to(x.device) for u in draws)
    if cfg.num_freq_masks > 0:
        full = torch.full((b, 1), f, dtype=torch.int32, device=x.device)
        fs, fw = rand_bands(fuw, fus, torch.full_like(full,
                                                      cfg.max_freq_width),
                            full)
        x = torch.where(band_mask(fs, fw, f)[:, None, :], fill, x)
    if cfg.num_time_masks > 0:
        frac = torch.tensor(cfg.max_time_frac, dtype=torch.float32)
        tmax = torch.clamp_max(torch.floor(frac * valid.float()).to(
            torch.int32), cfg.max_time_width)
        ts, tw = rand_bands(tuw, tus, tmax, valid)
        x = torch.where(band_mask(ts, tw, t)[:, :, None], fill, x)
    return x[..., None] if squeeze else x


def spec_draws(b: int, cfg: SpecAugmentConfig,
               generator: Optional[torch.Generator] = None,
               device=None) -> List[torch.Tensor]:
    """The four uniform [B, M] arrays of ``mask_features``, drawn on the
    generator's device (``device`` without one)."""
    dev = generator.device if generator is not None else device
    return [torch.rand((b, m), generator=generator, device=dev)
            for m in (cfg.num_freq_masks, cfg.num_freq_masks,
                      cfg.num_time_masks, cfg.num_time_masks)]


def spec_augment(feats: torch.Tensor, valid_frames: Optional[torch.Tensor],
                 cfg: SpecAugmentConfig = SpecAugmentConfig(),
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
    """SpecAugment masks on feats [B, T, F] (or [B, T, F, 1]) with
    ``valid_frames`` [B] (None: all T valid); the uniforms come from
    ``generator`` (None: torch's default)."""
    draws = spec_draws(feats.shape[0], cfg, generator, feats.device)
    return mask_features(feats, valid_frames, cfg, draws)
