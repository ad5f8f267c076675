"""Device ms a training step of the CTC loss's two kernels, by their
``__global__`` names (the profiler links no port op to them)."""

from portbench.readers import per

KERNELS = ("ctc_alpha_kernel", "ctc_beta_xi_kernel")


def read(rec):
    tr = rec.get("trace")
    return None if tr is None else per(rec, tr.kernel_s(KERNELS), "step")
