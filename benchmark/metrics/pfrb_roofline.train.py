"""Kernels 2 and 3 (`pfnl::pfrb_a`, `pfnl::pfrb_b`) in float32 inside training
steps: the sum of each traced call's bound (float32-exact work at 3xTF32)
over the sum of their device time, in %."""

from benchmark.core import group_roofline
from benchmark.counts.ops import COUNTERS


def read(rec):
    if rec["kind"] != "train":
        return None
    return group_roofline(rec.get("trace_ops"), ("pfnl::pfrb_a", "pfnl::pfrb_b"),
                          rec["config"]["train"]["dtype"], COUNTERS)
