"""Mean ms a clip of the Predictor's "predictor.read" span: the clip's LR
frames listed, read, stacked and made float32, and everything else before
its first dispatch, over the clips of the device span."""

from benchmark.program_spans import mean_ms


def read(rec):
    return mean_ms(rec, "predictor.read")
