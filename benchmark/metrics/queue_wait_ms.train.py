"""Mean ms a step of the pipeline's "pipeline.get_batch" span: the wait on
its queue of batches, over the steps of the device span."""

from benchmark.program_spans import mean_ms


def read(rec):
    return mean_ms(rec, "pipeline.get_batch")
