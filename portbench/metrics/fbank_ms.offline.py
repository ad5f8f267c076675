"""Device ms a batch of the front end: the activity launched inside the
port's ``asr_port::log_mel`` and ``asr_port::cmvn`` ops."""

from portbench.readers import per

OPS = ("asr_port::log_mel", "asr_port::cmvn")


def read(rec):
    tr = rec.get("trace")
    return None if tr is None else per(rec, tr.device_s_in(OPS), "batch")
