"""The readers of the per-layer metrics timed by the program's own spans
(`benchmark/program_spans.py`), on a synthetic record and recorder: each
reads only the spans that started in the device span, and reports nothing
without a traced device span, without spans there, or where the program
has no recorder (a checkout older than it)."""

import sys

import pytest

from benchmark import core

WINDOW = (10.0, 20.0, 2)  # the device span on the host clock: start, end (s), steps


def _span(name, t0_s, ms, id, parent=0, **counts):
    from pfnl_tpu_torch.utils.spans import Span

    t0 = int(round(t0_s * 1e9))
    return Span(name, t0, t0 + int(round(ms * 1e6)), id, parent, counts)


SERVE = [
    _span("predictor.clip", 11.0, 500, 1, frames=10, windows=12, padded=2),
    _span("predictor.read", 11.0, 10, 2, 1),
    _span("predictor.dispatch", 11.1, 2, 3, 1),
    _span("predictor.dispatch", 11.2, 4, 4, 1),
    _span("predictor.write", 11.3, 1, 5, 1),
    _span("predictor.write", 11.4, 3, 6, 1),
    _span("predictor.clip", 12.0, 400, 7, frames=8, windows=8, padded=0),
    _span("predictor.read", 12.0, 30, 8, 7),
    # outside the device span: before it, and in the operator span after it
    _span("predictor.dispatch", 9.0, 100, 9, 0),
    _span("predictor.clip", 25.0, 500, 10, frames=1, windows=4, padded=3),
    _span("predictor.read", 25.0, 100, 11, 10),
    _span("predictor.write", 25.1, 100, 12, 10),
]
TRAIN = [
    _span("pipeline.get_batch", 10.9, 0.1, 20),
    _span("train.step", 11.0, 50, 21, step=7),
    _span("train.upload", 11.0, 20, 22, 21),
    _span("pipeline.get_batch", 11.95, 0.3, 23),
    _span("train.step", 12.0, 60, 24, step=8),
    _span("train.upload", 12.0, 30, 25, 24),
    _span("pipeline.get_batch", 29.0, 5, 26),
    _span("train.step", 30.0, 1000, 27, step=9),
    _span("train.upload", 30.0, 500, 28, 27),
]
EXPECTED = {
    "read_ms.serve": (SERVE, (10 + 30) / 2),
    "dispatch_ms.serve": (SERVE, (2 + 4) / 2),
    "write_ms.serve": (SERVE, (1 + 3) / 2),
    "padded_window_pct.serve": (SERVE, 100.0 * 2 / 20),
    "upload_wait_ms.train": (TRAIN, (20 + 30) / 2),
    "host_enqueue_ms.train": (TRAIN, ((50 - 20) + (60 - 30)) / 2),
    "queue_wait_ms.train": (TRAIN, (0.1 + 0.3) / 2),
}


@pytest.fixture
def recorded(monkeypatch):
    from pfnl_tpu_torch.utils import spans

    def use(got):
        monkeypatch.setattr(spans, "records", lambda: list(got))
    return use


def test_every_span_metric_is_declared():
    declared = {m["name"]: m for m in core.manifest()["per_layer"]}
    for name in EXPECTED:
        src = "program_counter" if name == "padded_window_pct.serve" else "program_span"
        assert declared[name]["source"] == src


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_reads_the_spans_of_the_device_span(name, recorded):
    got, want = EXPECTED[name]
    recorded(got)
    assert core.reader(name)({"trace_span": WINDOW}) == pytest.approx(want, rel=1e-9)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_nothing_without_a_traced_device_span(name, recorded):
    recorded(EXPECTED[name][0])
    assert core.reader(name)({"trace_span": None}) is None
    assert core.reader(name)({}) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_nothing_without_spans_in_it(name, recorded):
    recorded([])
    assert core.reader(name)({"trace_span": WINDOW}) is None
    recorded(EXPECTED[name][0])
    assert core.reader(name)({"trace_span": (40.0, 50.0, 2)}) is None


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_nothing_where_the_program_has_no_recorder(name, recorded, monkeypatch):
    import pfnl_tpu_torch.utils

    recorded(EXPECTED[name][0])
    assert core.reader(name)({"trace_span": WINDOW}) is not None
    monkeypatch.delattr(pfnl_tpu_torch.utils, "spans")
    monkeypatch.setitem(sys.modules, "pfnl_tpu_torch.utils.spans", None)  # import raises
    assert core.reader(name)({"trace_span": WINDOW}) is None
