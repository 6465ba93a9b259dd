"""Mean ms a batch of the Predictor's "predictor.dispatch" span: the batch's
pinned staging, upload, forward, uint8 conversion and download enqueued
(on the host clock: the enqueue, not the device's work), over the batches
of the device span."""

from benchmark.program_spans import mean_ms


def read(rec):
    return mean_ms(rec, "predictor.dispatch")
