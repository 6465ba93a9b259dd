"""Share of the device span (its kept steps, on the host clock) in which no
kernel ran (training)."""

from benchmark.core import device_busy


def read(rec):
    got = device_busy(rec)
    if rec["kind"] != "train" or not got or got[1] <= 0:
        return None
    return 100.0 * (1.0 - got[0] / got[1])
