"""Device ms a training step of the acoustic model's forward: the activity
launched inside it (``portbench.am``, forward hooks)."""

from portbench.readers import per


def read(rec):
    tr = rec.get("trace")
    return None if tr is None else per(rec, tr.device_s_in(
        ["portbench.am"]), "step")
