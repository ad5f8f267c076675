"""Arithmetic the metric readers share (``metrics/<name>.py`` each read one
number from a run's record, or None when it finds nothing to read)."""

from __future__ import annotations

from typing import Optional

from portbench import work
from portbench.reference import fbank as rfbank

BF16_PEAK = work.PEAK_OPS_S["bf16"]


def per(rec: dict, seconds: Optional[float], span: str) -> Optional[float]:
    """Device seconds per traced ``portbench.<span>``, in ms."""
    tr = rec.get("trace")
    if tr is None or seconds is None:
        return None
    n = tr.count(f"portbench.{span}")
    return seconds / n * 1e3 if n else None


def idle_pct(rec: dict) -> Optional[float]:
    """The traced window less the union of device activity, over the
    window."""
    tr = rec.get("trace")
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def roofline_pct(bound_s: float, device_s: Optional[float]
                 ) -> Optional[float]:
    if not device_s or bound_s <= 0:
        return None
    return 100.0 * bound_s / device_s


def fbank_bound_s(rec: dict) -> float:
    """The least time of ``log_mel`` and ``cmvn`` over the batches done."""
    nfilt = rec["cfg"]["am"]["feature_dim"]
    bank = rfbank.mel_bank(nfilt)
    nnz = int((bank != 0).sum())
    total = 0.0
    for b in rec["done"]:
        lens = [int(x) for x in b.lengths]
        total += work.bound_s(work.add(
            work.log_mel(lens, b.bucket, nfilt, nnz, 4 * nnz),
            work.cmvn(lens, b.bucket, nfilt)))
    return total


def mfu_pct(rec: dict, flops: float) -> Optional[float]:
    tr = rec.get("trace")
    if tr is None or not tr.device or tr.window_s <= 0 or flops <= 0:
        return None
    return 100.0 * flops / tr.window_s / BF16_PEAK
