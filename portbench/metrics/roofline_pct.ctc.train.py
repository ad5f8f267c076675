"""The CTC kernels' share of their roofline: the least time of the alpha
and beta-xi passes over the cells each step's data needs (``work.py``, from
the logit and label lengths) over the device time of the two kernels, by
their ``__global__`` names (%)."""

from portbench import work
from portbench.readers import roofline_pct
from portbench.reference.fbank import logit_lengths

KERNELS = ("ctc_alpha_kernel", "ctc_beta_xi_kernel")


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    import torch
    bound = 0.0
    for b in rec.get("done", ()):
        t = b.bucket // 8
        lens = logit_lengths(torch.as_tensor(b.lengths), t).tolist()
        bound += work.bound_s(work.ctc(lens, b.label_lengths.tolist(), t))
    return roofline_pct(bound, tr.kernel_s(KERNELS))
