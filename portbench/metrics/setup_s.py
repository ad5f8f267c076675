"""From the process's start to the first measured request or step (s):
imports, the kernels' load or build, inputs, weights, warm-up."""


def read(rec):
    return rec.get("setup_s")
