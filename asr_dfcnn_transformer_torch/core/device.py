"""The device the port's entry points run on when the caller names none."""

from __future__ import annotations

import torch


def default_device(device=None) -> torch.device:
    """``device`` when given, else ``cuda``; raises when none is given and
    there is no CUDA device (an entry point never falls back to the CPU
    unasked)."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the port builds on cuda unless "
                           "given a device; pass device='cpu'")
    return torch.device("cuda")
