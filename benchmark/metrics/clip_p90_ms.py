"""90th percentile, over the clips completed inside the window, of the time
from the call that submits a clip to that call's return (ms)."""

from benchmark.core import p_quantile


def read(rec):
    if rec["kind"] != "serve":
        return None
    return p_quantile(rec["clip_ms"], 90)
