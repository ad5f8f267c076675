"""The whole batch's share of the chip's bf16 peak: the AM's and the LM's
operations for the batches done, from the configuration's widths at the
buckets run, over the traced window, against 989 TFLOP/s (%)."""

from portbench import work
from portbench.readers import mfu_pct


def read(rec):
    cfg = rec["cfg"]
    pos = cfg["lm"]["position_max_length"]
    flops = sum(len(b.lengths) * (work.am_flops(cfg, b.bucket)
                                  + work.lm_flops(cfg, pos))
                for b in rec.get("done", ()))
    return mfu_pct(rec, flops)
