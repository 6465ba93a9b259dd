"""Mean ms a step of the Trainer's "train.step" span less its "train.upload"
child: the host enqueueing the augmentation, forward, backward and Adam
update, over the steps of the device span."""

from benchmark.program_spans import in_device_span


def read(rec):
    got = in_device_span(rec)
    if got is None:
        return None
    window, every = got
    steps = [s for s in window if s.name == "train.step"]
    if not steps:
        return None
    upload = {}
    for s in every:
        if s.name == "train.upload":
            upload[s.parent] = upload.get(s.parent, 0) + s.t1_ns - s.t0_ns
    return sum(s.t1_ns - s.t0_ns - upload.get(s.id, 0) for s in steps) / len(steps) / 1e6
