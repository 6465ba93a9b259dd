"""Operations of a training step (forward and backward,
benchmark/counts/<model>_model.py) times the steps of the device span, per
second on the host clock, over the float32 peak (3xTF32, 165 TFLOP/s), in %."""

import importlib

from benchmark.counts.peaks import PEAK_FLOPS


def read(rec):
    span = rec.get("trace_span")
    if rec["kind"] != "train" or not span or span[1] <= span[0]:
        return None
    cfg = rec["config"]
    count = importlib.import_module(f"benchmark.counts.{cfg['model']}_model")
    s = rec["train_in_size"]
    ops = count.train_step_ops(cfg, rec["train_batch"], s, s) * span[2]
    return 100.0 * ops / (span[1] - span[0]) / PEAK_FLOPS[cfg["train"]["dtype"]]
