"""Kernel 9 (`pfnl::duf_block`) in bf16: the sum of each traced call's bound
over the sum of its calls' device time, in %."""

from benchmark.core import group_roofline
from benchmark.counts.ops import COUNTERS


def read(rec):
    if rec["kind"] != "serve":
        return None
    cfg = rec["config"]
    return group_roofline(rec.get("trace_ops"), ("pfnl::duf_block",), cfg["serve_dtype"], COUNTERS,
                          n_same=cfg["same_blocks"])
