"""90th-percentile latency (done - due arrival) over every request due
in the window; one that never finished counts as missing."""
from perfbench.readers import latency_p


def read(rec):
    return latency_p(rec, 0.9)
