"""Mean ms a step of the Trainer's "train.upload" span: the batch's upload
from pageable host memory, which waits for the device's earlier work,
over the steps of the device span."""

from benchmark.program_spans import mean_ms


def read(rec):
    return mean_ms(rec, "train.upload")
