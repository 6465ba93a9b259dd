"""Share of the device span (its kept clips, on the host clock) in which no
kernel ran (serving)."""

from benchmark.core import device_busy


def read(rec):
    got = device_busy(rec)
    if rec["kind"] != "serve" or not got or got[1] <= 0:
        return None
    return 100.0 * (1.0 - got[0] / got[1])
