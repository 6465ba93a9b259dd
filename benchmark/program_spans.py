"""The program's own host spans (`pfnl_tpu_torch/utils/spans.py`, recorded
while a torch.profiler records) that started inside the device span of a
traced run, for the readers of the per-layer metrics timed where the work
happens.  None where the program has no such recorder (a checkout older
than it), where the run was not traced, or where no such span started in
the device span: a reader then reports nothing."""



def in_device_span(rec):
    """(spans that started in the device span's [start, end) on the host
    clock, every span recorded), or None."""
    window = rec.get("trace_span")
    if not window:
        return None
    try:
        from pfnl_tpu_torch.utils import spans
    except ImportError:
        return None
    every = spans.records()
    lo, hi = window[0], window[1]
    return [s for s in every if lo <= s.t0_ns * 1e-9 < hi], every


def named(rec, name):
    """The spans called `name` that started in the device span, or None."""
    got = in_device_span(rec)
    if got is None:
        return None
    return [s for s in got[0] if s.name == name] or None


def mean_ms(rec, name):
    """Mean duration (ms) of the spans called `name` in the device span."""
    spans = named(rec, name)
    if not spans:
        return None
    return sum(s.t1_ns - s.t0_ns for s in spans) / len(spans) / 1e6
