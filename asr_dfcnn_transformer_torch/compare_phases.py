"""Time ``chip_smoke.py``'s phases in this tree against another checkout's,
in turns, on one card.

    python3 -m asr_dfcnn_transformer_torch.compare_phases --other DIR \\
        [--phases served,e2e_served,fused_ffn,am_family]
        [--cudnn-deterministic] [--out PATH]

``DIR`` is the root of another checkout of the repository (for example
the parent commit, unpacked with ``git archive``). Each run is a fresh
process in one root: it sets ``chip_smoke.main``'s backend flags, runs
``chip_smoke.phase_device`` (which builds that root's kernels, outside the
walls) and then each named phase ``chip_smoke.phase_<name>(results)``,
and reports each phase's wall to the card's synchronisation after it. The
name ``am_step`` is phase 5's AM training step alone (the full-width
SE-DFCNN in bf16, batch 16 at bucket 1600, Adam), reported also as ms a
step by CUDA events over steps 3-10 (``chip_smoke.train_steps``). The
runs go other, this, this, other, so that a drift of the card over the
call falls on both trees alike; a tree's figure is the mean of its two
runs. ``--cudnn-deterministic`` adds two runs of this tree with
``torch.backends.cudnn.deterministic`` in the middle. The default phases
are 3, 7, 11 and 14: whole-utterance serving, e2e serving, the
``fused_ffn="pallas"`` paths and the AM family. Each run's own output (the
phases' throughputs, latencies and ms a batch) is written beside ``PATH``
as ``PATH.run<i>.log``; ``PATH`` gets the JSON summary.
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
import json, sys, tempfile, time
import numpy as np, torch
import chip_smoke as cs
b = torch.backends
b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
b.cuda.matmul.allow_bf16_reduced_precision_reduction = False
b.cudnn.deterministic = sys.argv[2] == "1"
results = {n: {"name": n} for n in cs.KERNELS}


def am_step():
    from asr_dfcnn_transformer_torch.train import AMTrainer
    am, _, av, _ = cs.build_models(torch.bfloat16, cs.DEVICE)
    rng = np.random.default_rng(cs.SEED + 3)
    batch = cs.am_batch(rng, cs.AM_BATCH, cs.AM_BUCKET, cs.AM_LABELS,
                        av.size)
    gen = torch.Generator(device=cs.DEVICE).manual_seed(cs.SEED)
    return cs.train_steps("am", AMTrainer(am, tempfile.mkdtemp()), batch,
                          gen)["ms_per_step"]


cs.phase_device()
walls, ms = {}, {}
for name in sys.argv[1].split(","):
    t0 = time.perf_counter()
    if name == "am_step":
        ms[name] = am_step()
    else:
        getattr(cs, "phase_" + name)(results)
    torch.cuda.synchronize()
    walls[name] = time.perf_counter() - t0
print("PHASE_WALLS " + json.dumps({"walls": walls, "ms_per_step": ms}))
"""

#: the lines of a run's output that carry its phases' figures
FIGURES = ("utt/s", "chunk wall", "ms a batch", "ms/step")


def run(root: Path, phases: str, deterministic: bool, log: Path) -> dict:
    env = dict(os.environ, PYTHONPATH=str(root))
    proc = subprocess.run([sys.executable, "-c", RUN, phases,
                           "1" if deterministic else "0"], cwd=root,
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
    return {**json.loads(walls[-1].split(" ", 1)[1]), "figures": figures}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--other", required=True, type=Path)
    ap.add_argument("--phases",
                    default="served,e2e_served,fused_ffn,am_family")
    ap.add_argument("--cudnn-deterministic", action="store_true")
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
    det = [("this_cudnn_det", HERE, True)] * 2 \
        if args.cudnn_deterministic else []
    order = [("other", other, False), ("this", HERE, False), *det,
             ("this", HERE, False), ("other", other, False)]
    runs = []
    for i, (tree, root, deterministic) in enumerate(order):
        r = run(root, args.phases, deterministic, Path(f"{out}.run{i}.log"))
        runs.append({"tree": tree, **r})
        print(f"run {i} ({tree}): " + ", ".join(
            f"{k} {v:.2f} s" for k, v in r["walls"].items()) + "".join(
            f", {k} {v:.3f} ms/step" for k, v in r["ms_per_step"].items()))
        for line in r["figures"]:
            print(f"  {line}")
    trees = list(dict.fromkeys(tree for tree, _, _ in order))
    summary = {"device": smi, "other": str(other), "runs": runs,
               "mean_s": {}, "mean_ms_per_step": {}}
    for name in args.phases.split(","):
        for key, unit in (("walls", "s"), ("ms_per_step", "ms/step")):
            if name not in runs[0][key]:
                continue
            mean = {tree: sum(r[key][name] for r in runs
                              if r["tree"] == tree) / 2 for tree in trees}
            summary["mean_s" if key == "walls" else
                    "mean_ms_per_step"][name] = mean
            print(f"phase {name}: " + ", ".join(
                f"{tree} {v:.3f} {unit}" for tree, v in mean.items())
                + f" (this {100 * (mean['this'] / mean['other'] - 1):+.1f}%"
                " against other)")
    out.write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
