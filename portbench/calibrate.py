"""Read the numbers that set a cell's output limits, on the chip, in one
process: for each seed, the program's readings (a full run of the cell with
a short window) and the control's (the reference in fp8 in the program's
place, on the same requests or steps); for a training cell also, with
``--half-batch``, the program with half of each batch left out (its rows'
weights 0, the mean taken over the rest), and with ``--stale``, the
program replaying the third step's batch at every later step.

    python3 -m portbench.calibrate --workload <name> --seeds 1,2,3 \\
        --seconds 3 [--half-batch] [--stale] [--out calibrate.json]

Not run by the benchmark's own runs.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def _half_batch(system):
    """Plant the fault: every batch fed to the trainer keeps half its
    rows' weights."""
    plain = system.am_batch

    def half(b):
        out = plain(b)
        w = np.ones_like(out.weights)
        w[len(w) // 2:] = 0.0
        out.weights = w
        return out

    system.am_batch = half
    return lambda: setattr(system, "am_batch", plain)


def _stale():
    """Plant the fault: from its fourth call on, the trainer's step runs
    the third call's batch again."""
    from asr_dfcnn_transformer_torch.train import trainer
    plain = trainer.AMTrainer.train_step
    seen = []

    def stale(self, batch, generator=None):
        seen.append(batch)
        return plain(self, seen[min(len(seen), 3) - 1], generator)

    trainer.AMTrainer.train_step = stale
    return lambda: setattr(trainer.AMTrainer, "train_step", plain)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--half-batch", action="store_true")
    ap.add_argument("--stale", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    from portbench import manifest, run, system
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 3
    cell = manifest.cell(Path(manifest.MANIFEST), args.workload)
    result = {"workload": args.workload,
              "device": torch.cuda.get_device_name(0), "seeds": {}}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out, rec = run.execute(cell, seed, args.seconds, False, "cuda",
                               manifest.ROOT, time.perf_counter())
        row = {"program": rec["readings"], "correct": out["correct"],
               "metrics": {k: v["value"] for k, v in out["metrics"].items()}}
        row["control"] = rec["control"]()
        del rec
        faults = [("half_batch", lambda: _half_batch(system))] * \
            args.half_batch + [("stale", _stale)] * args.stale
        for name, plant in faults:
            restore = plant()
            try:
                _, rec = run.execute(cell, seed, args.seconds, False, "cuda",
                                     manifest.ROOT, time.perf_counter())
                row[name] = rec["readings"]
                del rec
            finally:
                restore()
        row["seconds"] = time.perf_counter() - t
        result["seeds"][seed] = row
        print(json.dumps({"seed": seed, **row}), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(result, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
