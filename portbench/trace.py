"""The traced run: ``torch.profiler`` over the window, host annotations
around the layers, and the reduction of the trace to what the per-layer
readers read.

Annotations (``torch.profiler.record_function``) are the benchmark's own:
``portbench.window`` around the measured window, ``portbench.batch`` /
``portbench.step`` around each batch or step, and, through forward hooks,
``portbench.am`` / ``portbench.lm`` around the models' forwards. A device
activity (kernel, copy, set) is attributed to the innermost host op that
launched it, which the profiler links by correlation id, and from there to
every annotation or op whose interval holds that launch.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

WINDOW = "portbench.window"
NAME_CHARS = 100


class Hooks:
    """Forward pre/post hooks that open and close a ``record_function``
    range named ``portbench.<name>`` around a module's forward."""

    def __init__(self):
        self._handles = []

    def attach(self, module: torch.nn.Module, name: str) -> None:
        stack = []
        label = f"portbench.{name}"

        def pre(mod, args):
            rf = torch.profiler.record_function(label)
            rf.__enter__()
            stack.append(rf)

        def post(mod, args, out):
            stack.pop().__exit__(None, None, None)

        self._handles += [module.register_forward_pre_hook(pre),
                          module.register_forward_hook(post)]

    def remove(self) -> None:
        for h in self._handles:
            h.remove()
        self._handles = []


@contextlib.contextmanager
def profiled(enabled: bool, device):
    """``torch.profiler`` with host and device activity while the block
    runs (a no-op when not ``enabled``); yields the profiler or None."""
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


def span(enabled: bool, name: str):
    """The annotation ``portbench.<name>`` in a traced run; nothing
    otherwise, so that an untraced run carries no instrumentation."""
    if not enabled:
        return contextlib.nullcontext()
    return torch.profiler.record_function(f"portbench.{name}")


def union_ns(intervals: Iterable[Tuple[int, int]], lo: int, hi: int) -> int:
    """Length of the union of intervals clipped to [lo, hi]."""
    iv = sorted((max(s, lo), min(e, hi)) for s, e in intervals
                if e > lo and s < hi)
    total, cur_s, cur_e = 0, None, None
    for s, e in iv:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps_ns(intervals: Iterable[Tuple[int, int]], lo: int, hi: int
            ) -> List[Tuple[int, int]]:
    """The idle stretches of [lo, hi] between the merged intervals."""
    iv = sorted((max(s, lo), min(e, hi)) for s, e in intervals
                if e > lo and s < hi)
    out, at = [], lo
    for s, e in iv:
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if at < hi:
        out.append((at, hi))
    return out


def _is_cuda(ev) -> bool:
    return ev.device_type() == torch.autograd.DeviceType.CUDA


class Trace:
    """The reduced trace of one window. Times in ns on the profiler's clock.

    ``device``: (start, end, name, launch time or None) of every device
    activity in the window; ``ranges``: name -> [(start, end)] of the host
    annotations and ops that readers ask for by name; ``window``: (start,
    end) of ``portbench.window``."""

    def __init__(self, window, device, ranges, host):
        self.window = window
        self.device = device
        self.ranges = ranges
        self._host = host        # (start, end, name) of host events

    @classmethod
    def from_profiler(cls, prof) -> Optional["Trace"]:
        events = prof.profiler.kineto_results.events()
        window, host, dev_raw, by_corr = None, [], [], {}
        for ev in events:
            if _is_cuda(ev):
                # the profiler also draws host annotations on the device's
                # timeline; those are no device activity
                if not (ev.is_user_annotation()
                        or ev.name().startswith("portbench.")):
                    dev_raw.append(ev)
                continue
            s, e, name = ev.start_ns(), ev.end_ns(), ev.name()
            if name == WINDOW:
                window = (s, e)
                continue
            host.append((s, e, name))
            cid = ev.correlation_id()
            if cid and not ev.linked_correlation_id():
                by_corr[cid] = s        # a host op (runtime calls link to one)
        if window is None:
            return None
        lo, hi = window
        device = []
        for ev in dev_raw:
            s, e = ev.start_ns(), ev.end_ns()
            if e <= lo or s >= hi:
                continue
            launch = by_corr.get(ev.linked_correlation_id())
            device.append((s, e, ev.name(), launch))
        ranges: Dict[str, List[Tuple[int, int]]] = {}
        for s, e, name in host:
            if name.startswith("portbench.") or name.startswith("asr_port::"):
                ranges.setdefault(name, []).append((s, e))
        return cls(window, device, ranges, host)

    # ---- what readers ask -------------------------------------------------

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_s(self) -> float:
        return union_ns(((s, e) for s, e, _, _ in self.device),
                        *self.window) / 1e9

    def count(self, name: str) -> int:
        lo, hi = self.window
        return sum(1 for s, e in self.ranges.get(name, ()) if s >= lo
                   and e <= hi)

    def device_s_in(self, names: Iterable[str]) -> Optional[float]:
        """Device seconds of the activities launched inside any range of
        the given host names; None when no such range is in the window."""
        iv = sorted(iv for n in names for iv in self.ranges.get(n, ()))
        if not iv or not self.device:
            return None
        starts = np.array([s for s, _ in iv], np.int64)
        ends = np.maximum.accumulate(np.array([e for _, e in iv], np.int64))
        launched = [(e - s, t) for s, e, _, t in self.device if t is not None]
        if not launched:
            return 0.0
        dur, at = (np.array(x, np.int64) for x in zip(*launched))
        i = np.searchsorted(starts, at, side="right") - 1
        inside = (i >= 0) & (ends[np.maximum(i, 0)] >= at)
        return float(dur[inside].sum()) / 1e9

    def kernel_s(self, patterns: Iterable[str]) -> Optional[float]:
        """Device seconds of the kernels whose name holds any pattern;
        None when none ran."""
        pats = tuple(patterns)
        hits = [e - s for s, e, name, _ in self.device
                if any(p in name for p in pats)]
        return sum(hits) / 1e9 if hits else None

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time, and the longest idle
        stretches by the shortest host event that covers each."""
        by_op: Dict[str, int] = {}
        for s, e, name, _ in self.device:
            by_op[name[:NAME_CHARS]] = by_op.get(name[:NAME_CHARS], 0) + e - s
        ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
        gaps = gaps_ns(((s, e) for s, e, _, _ in self.device), *self.window)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:2000]
        mids = np.array(sorted((s + e) // 2 for s, e in gaps), np.int64)
        length = {(s + e) // 2: e - s for s, e in gaps}
        label = [None] * len(mids)
        for s, e, name in sorted(self._host, key=lambda h: h[1] - h[0]):
            i, j = np.searchsorted(mids, s), np.searchsorted(mids, e, "right")
            for k in range(i, j):
                if label[k] is None:
                    label[k] = name[:NAME_CHARS]
        idle: Dict[str, int] = {}
        for m, lab in zip(mids.tolist(), label):
            lab = lab or "host: no traced op"
            idle[lab] = idle.get(lab, 0) + length[m]
        gap_top = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, t / 1e9] for n, t in ops],
                "idle_gaps": [[n, t / 1e9] for n, t in gap_top]}
