"""Kernels 5 and 6 (`pfnl::pfrb_bwd_b`, `pfnl::pfrb_bwd_a`), the PFRB backward
of training, in float32: the sum of each traced call's bound (float32-exact
work at 3xTF32) over the sum of their device time, in %."""

from benchmark.core import group_roofline
from benchmark.counts.ops import COUNTERS


def read(rec):
    if rec["kind"] != "train":
        return None
    return group_roofline(rec.get("trace_ops"), ("pfnl::pfrb_bwd_b", "pfnl::pfrb_bwd_a"),
                          rec["config"]["train"]["dtype"], COUNTERS)
