"""Time this tree's ``dual_axis_attention`` kernels against another
checkout's, in turns, on one card.

    python3 -m asr_dfcnn_transformer_torch.compare_dual_attention \\
        --other DIR [--out PATH]

``DIR`` is the root of another checkout of the repository (for example
the parent commit, unpacked with ``git archive``). Both kernel libraries
are built from their own ``csrc/`` (each by its own ``kernels/_build.py``)
and loaded into this one process. At the e2e pre-net's frequency rows,
[1072, 80, 64] bf16 (batch 8, bucket 1600), the forward and the backward
of each library run on the same seeded inputs: each is held to this
tree's plain twin (the forward within one bf16 ulp, the backward within
2e-2 with at most one element in 1000 differing), then timed with CUDA
events in turns (other, this, this, other) and by the profiler's device
time per launch. Beside them: the bound (bytes over 3.35 TB/s, the bf16
products over 989 TFLOP/s), and ``scaled_dot_product_attention`` on the
same rows, forward and backward (``autograd.grad``), by CUDA events and
by the device time of all its kernels per call. Prints the card's name
and power limit, then one JSON object, which ``--out`` also receives.
Needs one CUDA device; exits non-zero without one.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from asr_dfcnn_transformer_torch.kernels import _build
from asr_dfcnn_transformer_torch.kernels.dual_attention import (
    _scale, dual_axis_attention_bwd_reference, dual_axis_attention_reference)

SHAPE = (1072, 80, 64)       # B 8 x T' 134 rows of F' 80, C 64
PEAK_BYTES_S = 3.35e12       # H100 SXM, data sheet
PEAK_BF16_S = 989e12
ITERS = 50
KERNEL_NAMES = {             # __global__ names by library, bf16
    "fwd": ("dual_attention_kernel", "dual_attention_mma_kernel"),
    "bwd": ("dual_attention_bwd_kernel", "dual_attention_bwd_mma_kernel"),
}


def _other_library(root: Path):
    """The other checkout's kernel library, built by its own _build."""
    path = root / "asr_dfcnn_transformer_torch" / "kernels" / "_build.py"
    spec = importlib.util.spec_from_file_location("other_build", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.library()


def _cuda_ms(fn, iters: int = ITERS) -> float:
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def _device_us(fn, name: str | None, iters: int = 20) -> float:
    """Device time per call (us) of the kernels whose name contains
    ``name`` (all kernels where None), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages()
                if e.self_device_time_total and (name is None
                                                 or name in e.key))
    return total / iters


def _in_turns(other, this):
    o1, t1, t2, o2 = (_cuda_ms(f) for f in (other, this, this, other))
    return (o1 + o2) / 2, (t1 + t2) / 2


def _check_fwd(got, want) -> int:
    diff = (got.float() - want.float()).abs()
    _, e = torch.frexp(want.float())
    ulp = torch.where(want == 0, 2.0 ** -133,
                      torch.ldexp(torch.ones_like(diff), e - 8))
    if not bool((diff <= ulp).all()):
        raise SystemExit("forward disagrees with the twin by more than one "
                         "bf16 ulp")
    return int((got != want).sum())


def _check_bwd(got, want) -> int:
    n = 0
    for a, b in zip(got, want):
        d = (a.float() - b.float()).abs()
        if not bool((d <= 2e-2 + 2e-2 * b.float().abs()).all()):
            raise SystemExit("backward disagrees with the twin beyond 2e-2")
        n = max(n, int((a != b).sum()))
    if n > got[0].numel() // 1000:
        raise SystemExit(f"backward: {n} elements differ from the twin")
    return n


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    libs = {"other": _other_library(args.other.resolve()),
            "this": _build.library()}
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(SHAPE).astype(
        np.float32)).to(dev, torch.bfloat16) for _ in range(4))
    r, t, c = SHAPE
    scale = _scale(c)
    stream = _build.stream_ptr(dev)
    out = {n: torch.empty_like(q) for n in libs}
    grads = {n: tuple(torch.empty_like(q) for _ in range(3)) for n in libs}

    def fwd(n):
        def run():
            rc = libs[n].asr_dual_attention(
                1, q.data_ptr(), k.data_ptr(), v.data_ptr(),
                out[n].data_ptr(), r, t, c, scale, stream)
            if rc:
                raise SystemExit(f"{n} forward launch failed: {rc}")
        return run

    def bwd(n):
        def run():
            rc = libs[n].asr_dual_attention_bwd(
                1, q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
                *(x.data_ptr() for x in grads[n]), r, t, c, scale, stream)
            if rc:
                raise SystemExit(f"{n} backward launch failed: {rc}")
        return run

    want = dual_axis_attention_reference(q, k, v)
    want_b = dual_axis_attention_bwd_reference(q, k, v, g)
    res = {"shape": list(SHAPE), "dtype": "bfloat16",
           "device": torch.cuda.get_device_name(0)}
    for n in libs:
        fwd(n)()
        bwd(n)()
    torch.cuda.synchronize()
    for i, n in enumerate(libs):
        res[f"fwd_{n}_differing"] = _check_fwd(out[n], want)
        res[f"bwd_{n}_differing"] = _check_bwd(grads[n], want_b)
        res[f"fwd_{n}_device_us"] = _device_us(fwd(n), KERNEL_NAMES["fwd"][i])
        res[f"bwd_{n}_device_us"] = _device_us(bwd(n), KERNEL_NAMES["bwd"][i])
    res["fwd_other_ms"], res["fwd_this_ms"] = _in_turns(fwd("other"),
                                                        fwd("this"))
    res["bwd_other_ms"], res["bwd_this_ms"] = _in_turns(bwd("other"),
                                                        bwd("this"))
    n_bytes = 2 * r * t * c
    res["fwd_bound_ms"] = max(4 * n_bytes / PEAK_BYTES_S,
                              4 * r * t * t * c / PEAK_BF16_S) * 1e3
    res["bwd_bound_ms"] = max(7 * n_bytes / PEAK_BYTES_S,
                              10 * r * t * t * c / PEAK_BF16_S) * 1e3

    q4, k4, v4 = (x[:, None].detach().requires_grad_(True) for x in (q, k, v))
    sdpa = F.scaled_dot_product_attention(q4, k4, v4)
    g4 = g[:, None]

    def sdpa_fwd():
        with torch.no_grad():
            F.scaled_dot_product_attention(q4, k4, v4)

    def sdpa_bwd():
        torch.autograd.grad(sdpa, (q4, k4, v4), g4, retain_graph=True)

    res["sdpa_fwd_ms"] = _cuda_ms(sdpa_fwd)
    res["sdpa_fwd_device_us"] = _device_us(sdpa_fwd, None)
    res["sdpa_bwd_ms"] = _cuda_ms(sdpa_bwd)
    res["sdpa_bwd_device_us"] = _device_us(sdpa_bwd, None)
    for n in ("fwd", "bwd"):
        for side in ("other", "this"):
            res[f"{n}_{side}_share_of_bound"] = (
                res[f"{n}_bound_ms"] / (res[f"{n}_{side}_device_us"] / 1e3))
    line = json.dumps(res)
    print(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
