"""Mean ms a batch of the Predictor's "predictor.write" span: the batch's HR
frames handed to the sink, over the batches of the device span."""

from benchmark.program_spans import mean_ms


def read(rec):
    return mean_ms(rec, "predictor.write")
