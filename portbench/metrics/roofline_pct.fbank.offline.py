"""The front end's share of its roofline: the least time of ``log_mel``
and ``cmvn`` for the batches done (``work.py``, from their lengths) over
the device time of the two ops (%)."""

from portbench.readers import fbank_bound_s, roofline_pct

OPS = ("asr_port::log_mel", "asr_port::cmvn")


def read(rec):
    tr = rec.get("trace")
    if tr is None:
        return None
    return roofline_pct(fbank_bound_s(rec), tr.device_s_in(OPS))
