"""The model's operations per HR frame (benchmark/counts/<model>_model.py,
from the cell's LR size) times the HR frames delivered in the device span,
per second on the host clock, over the bf16 peak (989 TFLOP/s), in %."""

import importlib

from benchmark.counts.peaks import PEAK_FLOPS


def read(rec):
    span = rec.get("trace_span")
    if rec["kind"] != "serve" or not span or span[1] <= span[0]:
        return None
    cfg = rec["config"]
    h, w = rec["traffic"]["lr_hw"]
    count = importlib.import_module(f"benchmark.counts.{cfg['model']}_model")
    ops = count.forward_ops(cfg, 1, h, w) * rec["trace_frames"]
    return 100.0 * ops / (span[1] - span[0]) / PEAK_FLOPS[cfg["serve_dtype"]]
