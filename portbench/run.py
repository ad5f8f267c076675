"""Run one cell of the port's benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout (``BENCHMARK.json`` there). Loads, warms up,
measures for ``--seconds``, checks the outputs against the plain reference,
and prints one JSON line last on standard output: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``checks``, each compared number with its limit
(also the last lines of standard error). Exits non-zero, printing no
result, without enough CUDA devices, for an unknown workload, or when JAX
or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

FORBIDDEN = ("jax", "jaxlib", "flax", "asr_dfcnn_transformer_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's."""
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def execute(cell, seed: int, seconds: float, trace: bool, device,
            root: Path, started: float) -> tuple:
    """One run of ``cell`` on ``device`` -> (the result's fields, the
    driver's record)."""
    import torch

    from portbench import compare, harness, manifest
    ctx = harness.Context(cell, seed, seconds, trace, torch.device(device),
                          started)
    rec = manifest.driver(cell.traffic["driver"], root)(ctx)
    metrics = {}
    for m in (cell.per_layer if trace else cell.e2e):
        value = manifest.reader(m["name"], root)(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    limits = compare.limits_for(root, cell.name) or {}
    correct, checks = compare.judge(rec["readings"], limits, rec["missing"],
                                    rec["failed"])
    out = {"correct": bool(correct and limits),
           "attempted": rec["attempted"], "failed": rec["failed"],
           "metrics": metrics, "device": device_info(ctx, rec)}
    if trace and rec["trace"] is not None:
        out["breakdown"] = rec["trace"].breakdown()
    out["checks"] = checks
    return out, rec


def device_info(ctx, rec) -> dict:
    import torch
    dev = ctx.device
    info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu",
            "count": 1, "memory_peak_bytes": rec["memory_peak_bytes"]}
    tr = rec["trace"]
    if tr is not None:
        info["busy_s"] = tr.busy_s()
        info["window_s"] = tr.window_s
    return info


def main(argv=None) -> int:
    from portbench.harness import process_start
    started = process_start()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import compare, manifest
    try:
        cell = manifest.cell(Path(manifest.MANIFEST), args.workload)
    except (KeyError, OSError) as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    out, rec = execute(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda", manifest.ROOT, started)
    bad = forbidden_modules()
    if bad:
        print("portbench: loaded modules of JAX or the JAX package: "
              + ", ".join(bad), file=sys.stderr)
        return 4
    print("readings " + json.dumps(rec["readings"]), file=sys.stderr)
    for line in compare.check_lines(out["checks"]):
        print(line, file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
