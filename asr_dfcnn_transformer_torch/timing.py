"""Device timing shared by ``chip_smoke.py`` and ``compare_kernels``.

``cuda_ms`` reads CUDA events around a loop of calls; ``device_us`` reads
the device time of named kernels from ``torch.profiler``; ``library_us``
times a library call by the profiler, or by CUDA events where the trace
shows no device time; ``us_text`` writes either for a log; ``additive_mask``
is the float mask with which ``scaled_dot_product_attention`` computes
``masked_attention``'s function (the library yardstick of its backward at
keep 1.0). Needs a CUDA device.
"""

from __future__ import annotations

import torch

from asr_dfcnn_transformer_torch.kernels.attention import BIG_NEG


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of fn() in ms from CUDA events, after warm-up."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_us(fn, kernel, iters: int = 10, tries: int = 3):
    """Device time per call (us) of the ``__global__`` functions whose name
    contains ``kernel`` (every kernel fn launches where None, as for a
    library call's several kernels) over ``iters`` calls of fn, from
    torch.profiler. A trace can come back without the device's activity
    records, so an empty window is profiled again, up to ``tries`` windows;
    None when none of them shows device time for the kernels."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if (kernel is None or kernel in e.key) and e.count
                and e.self_device_time_total]
        if hits:
            return sum(e.self_device_time_total for e in hits) / iters
    return None


def library_us(fn, iters: int = 10) -> tuple[float, str]:
    """(us a call, how it was timed) of a library call: the device time of
    every kernel it launches (``device_us``), or, where the profiler shows
    none, CUDA events around ``iters`` calls after warm-up (which also
    count the gaps between its launches)."""
    us = device_us(fn, None, iters)
    if us is not None:
        return us, "profiler"
    return cuda_ms(fn, iters) * 1e3, "CUDA events"


def us_text(us) -> str:
    """A device time for a log line: "12.3 us", or "not measured"."""
    return "not measured" if us is None else f"{us:.1f} us"


def additive_mask(k_valid: torch.Tensor, tq: int, tk: int, causal: bool,
                  dtype: torch.dtype) -> torch.Tensor:
    """[B, 1, Tq, Tk] in ``dtype``: 0 where a key is valid (and not in the
    future, when causal), else the -1e9 that ``masked_attention`` adds, so
    that ``scaled_dot_product_attention(q, k, v, attn_mask=...)`` computes
    the same function, fully invalid rows included."""
    ok = k_valid[:, None, None, :]
    if causal:
        ok = ok & torch.ones((tq, tk), dtype=torch.bool,
                             device=k_valid.device).tril()
    return torch.where(ok, 0.0, BIG_NEG).to(dtype)
