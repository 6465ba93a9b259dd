"""Optimizer steps `Trainer.fit` completed in the window, over its seconds."""


def read(rec):
    if rec["kind"] != "train":
        return None
    return rec["steps"] / rec["window_s"]
