"""Time ``chip_smoke.py``'s phases in this tree against another checkout's,
in turns, on one card.

    python3 -m asr_dfcnn_transformer_torch.compare_phases --other DIR \\
        [--phases served,e2e_served,fused_ffn,am_family] [--out PATH]

``DIR`` is the root of another checkout of the repository (for example
the parent commit, unpacked with ``git archive``). Each run is a fresh
process in one root: it sets ``chip_smoke.main``'s backend flags, runs
``chip_smoke.phase_device`` (which builds that root's kernels, outside the
walls) and then each named phase ``chip_smoke.phase_<name>(results)``,
and reports each phase's wall to the card's synchronisation after it. The
runs go other, this, this, other, so that a drift of the card over the
call falls on both trees alike; a tree's wall is the mean of its two runs.
The default phases are 3, 7, 11 and 14: whole-utterance serving, e2e
serving, the ``fused_ffn="pallas"`` paths and the AM family. Each run's
own output (the phases' throughputs, latencies and ms a batch) is written
beside ``PATH`` as ``PATH.run<i>.log``; ``PATH`` gets the JSON summary.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]

RUN = """
import json, sys, time, torch
import chip_smoke as cs
b = torch.backends
b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
b.cuda.matmul.allow_bf16_reduced_precision_reduction = False
results = {n: {"name": n} for n in cs.KERNELS}
cs.phase_device()
walls = {}
for name in sys.argv[1].split(","):
    t0 = time.perf_counter()
    getattr(cs, "phase_" + name)(results)
    torch.cuda.synchronize()
    walls[name] = time.perf_counter() - t0
print("PHASE_WALLS " + json.dumps(walls))
"""

#: the lines of a run's output that carry its phases' figures
FIGURES = ("utt/s", "chunk wall", "ms a batch")


def run(root: Path, phases: str, log: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", RUN, phases], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=1800)
    log.write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise SystemExit(f"{root}: the run failed (rc {proc.returncode}); "
                         f"see {log}")
    walls = [line for line in proc.stdout.splitlines()
             if line.startswith("PHASE_WALLS ")]
    figures = [line.strip() for line in proc.stdout.splitlines()
               if any(f in line for f in FIGURES)]
    return {"walls": json.loads(walls[-1].split(" ", 1)[1]),
            "figures": figures}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--phases",
                    default="served,e2e_served,fused_ffn,am_family")
    ap.add_argument("--out", default="compare_phases.json")
    args = ap.parse_args()
    other = args.other.resolve()
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    order = [("other", other), ("this", HERE), ("this", HERE),
             ("other", other)]
    runs = []
    for i, (tree, root) in enumerate(order):
        r = run(root, args.phases, Path(f"{out}.run{i}.log"))
        runs.append({"tree": tree, **r})
        print(f"run {i} ({tree}): " + ", ".join(
            f"{k} {v:.2f} s" for k, v in r["walls"].items()))
        for line in r["figures"]:
            print(f"  {line}")
    summary = {"device": smi, "other": str(other), "runs": runs,
               "mean_s": {}}
    for name in args.phases.split(","):
        mean = {tree: sum(r["walls"][name] for r in runs
                          if r["tree"] == tree) / 2
                for tree in ("other", "this")}
        summary["mean_s"][name] = mean
        print(f"phase {name}: other {mean['other']:.2f} s, this "
              f"{mean['this']:.2f} s "
              f"({100 * (mean['this'] / mean['other'] - 1):+.1f}%)")
    out.write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
