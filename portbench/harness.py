"""What every driver shares: the run's context, the process's age, the
device's memory, and the release of the program's state before the
reference runs."""

from __future__ import annotations

import gc
import os
import time
from dataclasses import dataclass
from typing import Optional

import torch

from portbench.manifest import Cell


def process_start() -> float:
    """The process's start on the ``time.perf_counter`` clock (from
    ``/proc``; the first import of this module where that is unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - ticks / os.sysconf(
            "SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.perf_counter()


@dataclass
class Context:
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    started: float

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def reset_peak(self) -> int:
        """The peak so far (the set-up's), then a fresh peak."""
        if self.device.type != "cuda":
            return 0
        peak = torch.cuda.max_memory_allocated(self.device)
        torch.cuda.reset_peak_memory_stats(self.device)
        return peak

    def peak(self) -> int:
        if self.device.type != "cuda":
            return 0
        return torch.cuda.max_memory_allocated(self.device)


def release() -> None:
    """Hand the memory of the program's dropped state back, so that the
    reference runs in what the window left free."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def sample(r, n_items: int, k: int, longest: Optional[int]) -> list:
    """``k`` indices of ``n_items`` drawn by ``r``, ``longest`` among them."""
    idx = list(r.choice(n_items, size=min(k, n_items), replace=False))
    if longest is not None and longest not in idx:
        idx[0] = longest
    return sorted(int(i) for i in idx)
