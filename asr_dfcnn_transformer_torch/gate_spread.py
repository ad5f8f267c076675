"""Run the e2e accuracy gate (``gates.e2e_gate``) several times and print
each run's outcome: how far its accuracies move between runs of the same
code, with and without cuDNN's deterministic algorithms, and across initial
weights.

    python3 -m asr_dfcnn_transformer_torch.gate_spread [--device cuda] \\
        [--modes det,default,...] [--seeds 0,1,...] [--threads 1,2,...] \\
        [--kernel-init lecun|normal] [--out PATH]

Every (seed, threads) pair runs once per entry of ``--modes`` ("det": the
gate as phase 15 runs it; "default": cuDNN's default algorithms).
``--threads`` sets the CPU's intra-op threads, which change the order of
its sums. ``--kernel-init normal`` draws the Dense and Conv kernels from an
untruncated normal of the same variance, as the port did before its
kernels followed Flax's ``lecun_normal``. Each run prints one JSON line
(the gate's numbers and its misses); ``--out`` gets the list.
"""

from __future__ import annotations

import argparse
import json
import math
import tempfile

import torch

from asr_dfcnn_transformer_torch import gates
from asr_dfcnn_transformer_torch.models import layers, speech_transformer

KEYS = ("teacher_forced", "hanzi", "last_loss", "last_epoch_acc",
        "last_epoch_min", "wall_s")


def _untruncated(shape, fan_in, generator, device):
    return layers._param(shape, 1.0 / math.sqrt(fan_in), generator, device)


def _ints(text: str):
    return [int(x) for x in text.split(",") if x]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--modes", default="det,default")
    ap.add_argument("--seeds", default="0")
    ap.add_argument("--threads", default="",
                    help="CPU intra-op threads, comma-separated")
    ap.add_argument("--kernel-init", choices=("lecun", "normal"),
                    default="lecun")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    b = torch.backends
    b.cuda.matmul.allow_tf32 = b.cudnn.allow_tf32 = False
    b.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    if args.kernel_init == "normal":
        layers._lecun_normal = _untruncated
        speech_transformer._lecun_normal = _untruncated
    rows = []
    for seed in _ints(args.seeds):
        for threads in _ints(args.threads) or [None]:
            if threads:
                torch.set_num_threads(threads)
            for mode in args.modes.split(","):
                with tempfile.TemporaryDirectory(prefix="gate_spread_") as d:
                    out = gates.e2e_gate(d, args.device, init_seed=seed,
                                         deterministic=mode == "det")
                row = {"seed": seed, "threads": threads, "mode": mode,
                       "kernel_init": args.kernel_init,
                       **{k: out[k] for k in KEYS},
                       "misses": gates.e2e_misses(out)}
                print(json.dumps(row), flush=True)
                rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
