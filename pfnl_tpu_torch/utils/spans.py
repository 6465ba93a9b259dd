"""Spans of the port's host work at its layer boundaries, recorded while a
torch.profiler traces and at no other time.

    with span("predictor.clip") as clip:
        ...
        clip.count(frames=10, windows=12, padded=2)

`torch.profiler` sets `torch.autograd.profiler._is_profiler_enabled` while
it records (not in a schedule's warm-up steps, whatever its activities), so
a span costs one attribute check when no profiler records.  While one does,
a span stamps its start and end with `time.perf_counter_ns()`, keeps its
parent (the innermost span open on the thread), an id of its own and its
counts, and enters `torch._C._profiler._RecordFunctionFast(name)`, so it
appears in the trace as a CPU event on the kernels' timeline.
`torch.profiler.record_function` is not used: it is a user annotation,
which a CUDA trace may mirror onto the device timeline as a CUDA-typed
event.  Names never start with "pfnl::", the prefix of the port's kernel
ops (`torch.ops.pfnl`).

`records()` returns what was recorded in the order the spans ended, the
last `MAX_RECORDS` of them.
"""

import collections
import itertools
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

MAX_RECORDS = 65536


class Span(NamedTuple):
    name: str
    t0_ns: int
    t1_ns: int
    id: int
    parent: int  # the enclosing span's id, 0 for none
    counts: dict


_records = collections.deque(maxlen=MAX_RECORDS)
_ids = itertools.count(1)
_local = threading.local()


class _Off:
    """The span of every site while no profiler records: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, **counts):
        pass


OFF = _Off()


class _On:
    __slots__ = ("name", "counts", "id", "parent", "t0", "_fn")

    def __init__(self, name, counts):
        self.name, self.counts, self.id = name, counts, next(_ids)

    def __enter__(self):
        stack = _local.__dict__.setdefault("stack", [])
        self.parent = stack[-1] if stack else 0
        stack.append(self.id)
        self._fn = torch._C._profiler._RecordFunctionFast(self.name)
        self._fn.__enter__()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        self._fn.__exit__(*exc)
        _local.stack.pop()
        _records.append(Span(self.name, self.t0, t1, self.id, self.parent, self.counts))
        return False

    def count(self, **counts):
        """Sets counts of the span (those known only once its work is done)."""
        self.counts.update(counts)


def span(name: str, **counts):
    """A context manager around one piece of host work; `count(**counts)` on
    what it returns sets counts later."""
    if not _profiler._is_profiler_enabled:
        return OFF
    return _On(name, counts)


def records():
    """The spans recorded, in the order they ended (a copy)."""
    return list(_records)


def clear():
    _records.clear()
