"""Kernels 2 and 3 (`pfnl::pfrb_a`, `pfnl::pfrb_b`) in bf16: the sum of each
traced call's bound over the sum of their device time, in %."""

from benchmark.core import group_roofline
from benchmark.counts.ops import COUNTERS


def read(rec):
    if rec["kind"] != "serve":
        return None
    return group_roofline(rec.get("trace_ops"), ("pfnl::pfrb_a", "pfnl::pfrb_b"),
                          rec["config"]["serve_dtype"], COUNTERS)
