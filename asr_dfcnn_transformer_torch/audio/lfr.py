"""Low-frame-rate feature stacking: the port of ``audio/lfr.py``.

Stack ``m`` consecutive frames every ``n`` frames; the tail repeats the
last frame. With the defaults m=4, n=3 a [T, D] feature matrix becomes
[ceil(T/3), 4*D] at one third the frame rate. Plain torch gathers.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch


def lfr_length(t: int, n: int = 3) -> int:
    return int(math.ceil(t / n))


def _window_index(t: int, m: int, n: int, device) -> torch.Tensor:
    """[ceil(t/n), m] frame indices ``n*i + j`` (not yet clipped)."""
    rows = torch.arange(lfr_length(t, n), device=device)
    return n * rows[:, None] + torch.arange(m, device=device)[None, :]


def build_lfr_features(feat: torch.Tensor, m: int = 4,
                       n: int = 3) -> torch.Tensor:
    """[T, D] -> [ceil(T/n), m*D]: output row i gathers input rows
    ``min(i*n + j, T-1)`` for j in [0, m), which repeats the last frame
    over the tail."""
    t, d = feat.shape
    idx = torch.clamp(_window_index(t, m, n, feat.device), max=t - 1)
    return feat[idx].reshape(idx.shape[0], m * d)


def batched_lfr(feat: torch.Tensor, valid: torch.Tensor, m: int = 4,
                n: int = 3) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, T, D] + [B] valid frames -> ([B, ceil(T/n), m*D], [B] int32
    valid LFR rows).

    Equals :func:`build_lfr_features` of each utterance on its valid rows:
    a window that crosses an utterance's end repeats ITS last valid frame
    (``valid-1``), not the padded buffer's. The valid row count is
    ceil(valid/n); rows past it are zero."""
    b, t, d = feat.shape
    idx = _window_index(t, m, n, feat.device)                  # [T_lfr, m]
    t_lfr = idx.shape[0]
    last = torch.clamp_min(valid.to(feat.device, torch.int64) - 1, 0)
    idx = torch.minimum(idx[None], last[:, None, None])        # [B, T_lfr, m]
    out = torch.gather(feat, 1, idx.reshape(b, t_lfr * m, 1).expand(-1, -1, d))
    out = out.reshape(b, t_lfr, m * d)
    valid_lfr = torch.div(valid.to(feat.device, torch.int64) + n - 1, n,
                          rounding_mode="floor").to(torch.int32)
    rows = torch.arange(t_lfr, device=feat.device)[None, :, None]
    return out * (rows < valid_lfr[:, None, None]).to(out.dtype), valid_lfr
