"""Kernel 1 (`pfnl::nonlocal_flash`) in bf16: the sum of each traced call's
bound over the sum of its calls' device time, in %."""

from benchmark.core import group_roofline
from benchmark.counts.ops import COUNTERS


def read(rec):
    if rec["kind"] != "serve":
        return None
    return group_roofline(rec.get("trace_ops"), ("pfnl::nonlocal_flash",),
                          rec["config"]["serve_dtype"], COUNTERS)
