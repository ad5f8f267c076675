"""The training step's share of the chip's bf16 peak: the AM's forward and
backward operations for the steps done, from the configuration's widths at
the bucket run, over the traced window, against 989 TFLOP/s (%)."""

from portbench import work
from portbench.readers import mfu_pct


def read(rec):
    cfg = rec["cfg"]
    flops = sum(len(b.lengths) * work.train_flops(cfg, b.bucket)
                for b in rec.get("done", ()))
    return mfu_pct(rec, flops)
