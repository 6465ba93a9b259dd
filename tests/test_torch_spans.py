"""The port's host spans (utils/spans.py): off unless a torch.profiler
records, recorded in its active steps only, in its trace as plain CPU
events, nested by thread, and placed at the Predictor's and the Trainer's
layer boundaries.  CPU, but for the one `gpu` test, which runs on the card
(`python -m pytest --noconftest -m gpu tests/test_torch_spans.py`)."""

import ast
import collections
import glob
import os
import threading
import time

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, schedule

from pfnl_tpu_torch.config import preset
from pfnl_tpu_torch.data.frames import MemoryFrames
from pfnl_tpu_torch.data.manifest import Sequence
from pfnl_tpu_torch.data.pipeline import TrainPipeline
from pfnl_tpu_torch.infer.predictor import Predictor
from pfnl_tpu_torch.models.frvsr import FRVSR
from pfnl_tpu_torch.models.pfnl import PFNL
from pfnl_tpu_torch.train.trainer import Trainer
from pfnl_tpu_torch.utils import spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROGRAM_SPANS = {"predictor.clip", "predictor.read", "predictor.dispatch", "predictor.wait",
                 "predictor.write", "train.step", "train.upload", "pipeline.get_batch"}


@pytest.fixture(autouse=True)
def empty_recorder():
    spans.clear()
    yield
    spans.clear()


def _stepped(activities, n=5, warmup=1, active=2):
    """n steps under a profiler scheduled (wait 0, warmup, active), span "s<i>"
    in step i; returns (the profiler, the profiler flag seen in each step)."""
    seen = []
    with profile(activities=activities,
                 schedule=schedule(wait=0, warmup=warmup, active=active, repeat=1)) as prof:
        for i in range(n):
            seen.append(torch.autograd.profiler._is_profiler_enabled)
            with spans.span(f"s{i}", step=i):
                torch.ones(4).add_(1)
            prof.step()
    return prof, seen


def test_off_without_a_profiler():
    got = spans.span("off", frames=3)
    assert got is spans.OFF
    with got as s:
        s.count(windows=4)
    assert spans.records() == []


def test_recorded_in_the_active_steps_only():
    _, seen = _stepped([ProfilerActivity.CPU])
    assert seen == [False, True, True, False, False]
    got = spans.records()
    assert [s.name for s in got] == ["s1", "s2"]
    assert [s.counts for s in got] == [{"step": 1}, {"step": 2}]
    assert all(s.parent == 0 and s.t1_ns >= s.t0_ns for s in got)
    assert not torch.autograd.profiler._is_profiler_enabled


def test_in_the_trace_as_cpu_events_and_not_user_annotations():
    prof, _ = _stepped([ProfilerActivity.CPU])
    events = [e for e in prof.events() if e.name in ("s1", "s2")]
    assert sorted(e.name for e in events) == ["s1", "s2"]
    assert all(e.device_type == DeviceType.CPU and not e.is_user_annotation for e in events)
    assert all(e.cpu_parent is not None and e.cpu_parent.name.startswith("ProfilerStep")
               for e in events)


def _one_span(name):
    with spans.span(name):
        pass


def test_clock_nesting_and_threads():
    with profile(activities=[ProfilerActivity.CPU]):
        before = time.perf_counter_ns()
        with spans.span("outer") as outer:
            with spans.span("inner"):
                pass
            other = threading.Thread(target=_one_span, args=("other",))
            other.start()
            other.join(timeout=10)
            outer.count(n=2)
        after = time.perf_counter_ns()
    assert not other.is_alive()
    got = {s.name: s for s in spans.records()}
    assert got["inner"].parent == got["outer"].id
    assert got["other"].parent == 0  # another thread's stack
    assert got["outer"].counts == {"n": 2}
    assert before <= got["outer"].t0_ns <= got["inner"].t0_ns <= got["inner"].t1_ns
    assert got["inner"].t1_ns <= got["outer"].t1_ns <= after


def test_a_profiler_stopped_inside_a_span():
    prof = profile(activities=[ProfilerActivity.CPU])
    prof.__enter__()
    s = spans.span("cut")
    s.__enter__()
    prof.__exit__(None, None, None)
    s.__exit__(None, None, None)
    assert [r.name for r in spans.records()] == ["cut"]


def _span_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    return {node.args[0].value for node in ast.walk(tree)
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
            and node.func.id == "span" and node.args and isinstance(node.args[0], ast.Constant)}


def test_the_program_spans_and_no_kernel_op_prefix():
    """The port's span names, read from its sources: the eight of the layer
    boundaries, none with "pfnl::", the prefix of the kernel ops."""
    names = set()
    for path in glob.glob(os.path.join(ROOT, "pfnl_tpu_torch", "**", "*.py"), recursive=True):
        names |= _span_names(path)
    assert names == PROGRAM_SPANS
    assert not any(n.startswith("pfnl::") for n in names)


def _children(got, parent):
    return dict(collections.Counter(s.name for s in got if s.parent == parent.id))


@pytest.mark.parametrize("family", ["pfnl", "frvsr"])
def test_predictor_clip_spans(family):
    """One clip of 10 frames.  PFNL at 4 windows a batch: 3 batches, 12
    windows computed, 2 of them padding.  FRVSR: frame 0, then one chunk of
    9, every frame computed once."""
    torch.manual_seed(0)
    gen = torch.Generator().manual_seed(0)
    if family == "pfnl":
        model = PFNL(num_frames=3, num_blocks=1, generator=gen).eval()
        units, counts = 3, {"frames": 10, "windows": 12, "padded": 2}
    else:
        model = FRVSR(num_frames=3, mf=8, num_blocks=1, generator=gen).eval()
        units, counts = 2, {"frames": 10, "windows": 10, "padded": 0}
    rng = np.random.default_rng(0)
    store = MemoryFrames({f"clip/blur4/{k:04d}.png": rng.integers(0, 256, (8, 10, 3), np.uint8)
                          for k in range(10)})
    sink = MemoryFrames()
    pred = Predictor(model, batch_windows=4, source=store, sink=sink)
    with profile(activities=[ProfilerActivity.CPU]):
        all_time = pred.test_video_lr("clip", name="sr")
    assert len(all_time) == units and len(sink.frames) == 10
    got = spans.records()
    clips = [s for s in got if s.name == "predictor.clip"]
    assert len(clips) == 1 and clips[0].parent == 0
    assert clips[0].counts == counts
    assert _children(got, clips[0]) == {"predictor.read": 1, "predictor.dispatch": units,
                                        "predictor.wait": units, "predictor.write": units}
    read = next(s for s in got if s.name == "predictor.read")
    first = min(s.t0_ns for s in got if s.name == "predictor.dispatch")
    assert read.t1_ns <= first
    assert clips[0].t0_ns <= read.t0_ns and max(s.t1_ns for s in got) <= clips[0].t1_ns


def test_trainer_step_spans(tmp_path):
    """Two steps of fit: two "train.step" spans counting the global step,
    each with one "train.upload" child, and two "pipeline.get_batch"."""
    rng = np.random.default_rng(0)
    paths = [f"seq/truth/{k:04d}.png" for k in range(6)]
    store = MemoryFrames({p: rng.integers(0, 256, (40, 40, 3), np.uint8) for p in paths})
    cfg = preset("pfnl", num_frames=3, in_size=8, batch_size=2, reload=False,
                 save_dir=str(tmp_path), host_threads=1)
    tr = Trainer(cfg, model=PFNL(num_frames=3, num_blocks=1,
                                 generator=torch.Generator().manual_seed(0)), device="cpu")
    pipe = TrainPipeline([Sequence(path="seq", truth=paths, blur=[])], "single", 3, 8, 4, 2,
                         seed=0, num_threads=1, prefetch=2, source=store)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            tr.fit(pipe, max_steps=2, save_every=10 ** 9, print_fn=lambda *a: None)
    finally:
        pipe.close()
    got = spans.records()
    steps = [s for s in got if s.name == "train.step"]
    assert [s.counts for s in steps] == [{"step": 0}, {"step": 1}]
    assert [_children(got, s) for s in steps] == [{"train.upload": 1}] * 2
    assert sum(s.name == "pipeline.get_batch" for s in got) == 2


@pytest.mark.gpu
def test_spans_under_a_cuda_only_trace():
    """The benchmark's device span traces CUDA alone: the spans record in its
    active steps all the same, and none is mirrored onto the device timeline."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    x = torch.ones(1 << 20, device="cuda")
    seen = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=2, repeat=1)) as prof:
        for i in range(4):
            seen.append(torch.autograd.profiler._is_profiler_enabled)
            with spans.span(f"s{i}"):
                x.mul_(1.0001)
            prof.step()
    torch.cuda.synchronize()
    assert seen == [False, True, True, False]
    assert [s.name for s in spans.records()] == ["s1", "s2"]
    names = {f"s{i}" for i in range(4)}
    assert not [e for e in prof.events() if e.name in names and e.device_type == DeviceType.CUDA]
