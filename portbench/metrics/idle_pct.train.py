"""The traced window less the union of device activity intervals, over the
window (%)."""

from portbench.readers import idle_pct


def read(rec):
    return idle_pct(rec)
