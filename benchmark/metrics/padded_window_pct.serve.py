"""Share (%) of the windows the Predictor computed only to fill a clip's
last batch: the "padded" over the "windows" counts of the
"predictor.clip" spans of the device span."""

from benchmark.program_spans import named


def read(rec):
    clips = named(rec, "predictor.clip")
    windows = sum(c.counts.get("windows", 0) for c in clips or ())
    if not windows:
        return None
    return 100.0 * sum(c.counts.get("padded", 0) for c in clips) / windows
