"""Device ms a batch of the acoustic model: the activity launched inside
its forward (``portbench.am``, forward hooks)."""

from portbench.readers import per


def read(rec):
    tr = rec.get("trace")
    return None if tr is None else per(rec, tr.device_s_in(
        ["portbench.am"]), "batch")
