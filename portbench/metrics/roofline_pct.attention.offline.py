"""The LM attention forward's share of its roofline: the least time of the
causal masked attention of every block for the batches done (``work.py``,
from the configuration's heads and the LM's positions) over the device time
of the port's ``asr_port::masked_attention`` op (%)."""

from portbench import work
from portbench.readers import roofline_pct

OPS = ("asr_port::masked_attention",)


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    m = rec["cfg"]["lm"]
    dh = m["d_model"] // m["num_heads"]
    bound = sum(m["num_blocks"] * work.bound_s(work.causal_attention(
        len(b.lengths), m["num_heads"], m["position_max_length"], dh))
        for b in rec["done"])
    return roofline_pct(bound, tr.device_s_in(OPS))
