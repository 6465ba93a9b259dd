"""The harness: a cell found by name, one run of it, and its result line.

Everything that belongs to one configuration, one traffic mix or one
metric is a file of its own, found by name:

  BENCHMARK.json (the checkout's root)   the cells, the metrics, their bounds
  benchmark/configs/<file>               a configuration (the manifest names it)
  benchmark/traffic/<traffic>.json       a traffic mix; its "driver" names the code
  benchmark/drivers/<driver>.py          run(ctx) -> the run's record
  benchmark/reference/<model>.py         the plain reference of a configuration's "model"
  benchmark/metrics/<metric>.py          read(record) -> a number, or None
  benchmark/limits/<cell>.json           the limit of each number `correct` compares

A cell is a pair of a configuration and a traffic mix, so it needs no file
of its own beyond its limits.  A model's reference module gives what the
drivers call: serving, `LR_MULTIPLE` (the multiple its LR frames are
edge-padded to) and `serve(p, x, cfg, prec)` (a window batch [N,T,h,w,3] of
LR RGB in [0, 1] -> HR RGB [N,S h,S w,3]); training, `train_loss(p, gt, lr,
cfg)` (the loss of the SR of the degraded window against gt's centre frame).
"""

import importlib.util
import json
import math
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "pfnl_tpu")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def manifest(root=ROOT):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def cell(name, root=ROOT):
    """The cell's entry, configuration, traffic mix, limits and metrics."""
    bench = manifest(root)
    here = os.path.join(root, "benchmark")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(cells)}")
    work = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(root, configs[work["config"]]["file"]))
    traffic = load_json(os.path.join(here, "traffic", work["traffic"] + ".json"))
    limits = load_json(os.path.join(here, "limits", name + ".json"))

    def mine(m):
        return name in m.get("workloads", [name])

    return dict(work=work, config=config, traffic=traffic, limits=limits, root=root,
                end_to_end=[m for m in bench["end_to_end"] if mine(m)],
                per_layer=[m for m in bench["per_layer"] if mine(m)])


def _load(kind, name, root):
    """benchmark/<kind>/<name>.py under root, loaded by path (a name may hold dots)."""
    path = os.path.join(root, "benchmark", kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"benchmark_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(traffic, root=ROOT):
    """The module that runs a traffic mix: benchmark/drivers/<driver>.py."""
    return _load("drivers", traffic["driver"], root)


def reader(metric_name, root=ROOT):
    """The reader of a metric: benchmark/metrics/<name>.py's read(record)."""
    return _load("metrics", metric_name, root).read


def reference(config, root=ROOT, needs=()):
    """The plain reference of the configuration's model,
    benchmark/reference/<config["model"]>.py, holding every entry of `needs`;
    a LookupError that names the file and the model where either is missing."""
    model = config["model"]
    rel = f"benchmark/reference/{model}.py"
    if not os.path.isfile(os.path.join(root, rel)):
        raise LookupError(f"{rel} is missing: no plain reference of model {model!r}")
    mod = _load("reference", model, root)
    missing = [n for n in needs if not hasattr(mod, n)]
    if missing:
        raise LookupError(f"{rel}, the plain reference of model {model!r}, lacks "
                          + ", ".join(missing))
    return mod


def p_quantile(values, q: int, n: int = 100):
    """The q-th of the n-quantiles of values (statistics.quantiles, inclusive)."""
    if len(values) < 2:
        return None
    return statistics.quantiles(values, n=n, method="inclusive")[q - 1]


def judge(rec, limits):
    """(correct, {name: {"value", "limit"}}): every attempt succeeded and
    every compared number is finite and within its limit."""
    checks = {}
    for k, v in limits.items():
        got = rec["checks"].get(k)
        checks[k] = {"value": got if got is not None and math.isfinite(got) else None, "limit": v}
    correct = (rec["failed"] == 0 and rec["attempted"] > 0
               and all(c["value"] is not None and c["value"] <= c["limit"]
                       for c in checks.values()))
    return correct, checks


class Context:
    """What a driver needs: the cell, the seed, the window, the device."""

    def __init__(self, spec, seed, seconds, trace, device, t_process):
        self.spec, self.seed, self.seconds, self.trace = spec, seed, seconds, trace
        self.device, self.t_process = device, t_process
        self.config, self.traffic = spec["config"], spec["traffic"]
        self.marks = [("start", t_process)]

    def mark(self, name: str):
        """Note the end of a set-up phase (printed on standard error)."""
        self.marks.append((name, time.perf_counter()))

    def phases(self):
        return [(n, t - self.marks[i][1]) for i, (n, t) in enumerate(self.marks[1:])]

    def sub_seed(self, k: int) -> int:
        """A seed of its own for each use k, from the run's seed (any size)."""
        return (self.seed * 1_000_003 + 7919 * k) % (2 ** 62)


class Tracer:
    """torch.profiler over two spans of a run, one after the other, by steps:
    `step()` after each clip or training step.  "device" traces the card
    alone (CUPTI's kernel records, next to no host cost): busy and idle
    time, kernel time by name, the rate of the span.  "ops" then traces the
    host's operators too, with their shapes: the program's kernel ops for
    the rooflines, and what the host was doing in each idle gap.  Each span
    traces `warm` steps and drops them, then keeps `active` (the traffic's
    "trace": {"device": [warm, active], "ops": [warm, active]}).  A traced
    run goes on past its window until both spans are done (`pending`); the
    traces are read only once the run is over.  Off unless enabled."""

    def __init__(self, traffic, enabled: bool):
        self.plan = traffic["trace"] if enabled else {}
        self.todo = [p for p in ("device", "ops") if p in self.plan]
        self.cur, self.results = None, {}

    def _begin(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, schedule

        phase = self.todo.pop(0)
        warm, active = self.plan[phase]
        card = [ProfilerActivity.CUDA] if torch.cuda.is_available() else []
        acts = card + ([ProfilerActivity.CPU] if phase == "ops" or not card else [])
        prof = profile(activities=acts, record_shapes=phase == "ops",
                       schedule=schedule(wait=0, warmup=warm, active=active, repeat=1),
                       on_trace_ready=self._ready)
        self.cur = dict(phase=phase, warm=warm, marks=[time.perf_counter()], prof=prof)
        prof.__enter__()

    def _ready(self, prof):
        c = self.cur
        self.results[c["phase"]] = dict(prof=prof, marks=list(c["marks"]), warm=c["warm"])

    def start(self):
        if self.todo:
            self._begin()

    def step(self):
        c = self.cur
        if c is None:
            return
        c["marks"].append(time.perf_counter())
        c["prof"].step()
        if c["phase"] in self.results:
            c["prof"].__exit__(None, None, None)
            self.cur = None
            if self.todo:
                self._begin()

    def pending(self) -> bool:
        return self.cur is not None or bool(self.todo)

    def stop(self):
        """Ends a span cut short: its kept steps so far count."""
        c = self.cur
        if c is not None:
            c["marks"].append(time.perf_counter())
            c["prof"].__exit__(None, None, None)
            self.cur = None

    def span(self, phase):
        """(start, end, steps) on the host clock of a span's kept steps, or None."""
        r = self.results.get(phase)
        if r is None or len(r["marks"]) <= r["warm"] + 1:
            return None
        marks = r["marks"]
        return marks[r["warm"]], marks[-1], len(marks) - 1 - r["warm"]

    def summary(self, phase):
        r = self.results.get(phase)
        if r is None:
            return None
        if "summary" not in r:
            r["summary"] = summarize(r.pop("prof").events())
        return r["summary"]

    def record(self):
        """A traced run's part of the record: the device span's summary and
        its host span (start, end, steps), the operator span's summary."""
        return dict(trace_device=self.summary("device"), trace_span=self.span("device"),
                    trace_ops=self.summary("ops"))


def summarize(events):
    """What the readers take from a trace: kernel intervals (s), the
    program's kernel ops with their shapes and device seconds, the traced
    window, the busy seconds in it, and the longest idle gaps with the host
    operation open across each."""
    from torch.autograd import DeviceType

    kernels, cpu, steps, ops = [], [], [], []
    for e in events:
        start, end = e.time_range.start / 1e6, e.time_range.end / 1e6
        if e.device_type == DeviceType.CUDA:
            kernels.append((start, end, e.name))
        elif e.name.startswith("ProfilerStep"):
            steps.append((start, end))
        else:
            cpu.append((start, end, e.name))
            if e.name.startswith("pfnl::") and not _has_ancestor(e, e.name):
                ops.append(dict(name=e.name, shapes=[list(s) for s in (e.input_shapes or [])],
                                scalars=_scalars(e), device_s=e.device_time_total / 1e6,
                                kernels=sorted({k.name for k in getattr(e, "kernels", [])})))
    if not kernels:
        return dict(kernels=[], ops=ops, window_s=0.0, busy_s=0.0, gaps=[])
    kernels.sort()
    lo = min([s for s, _ in steps] or [kernels[0][0]])
    hi = max([e for _, e in steps] + [kernels[-1][1]])
    busy, gaps, at = 0.0, [], lo
    for s, e, _ in kernels:
        s, e = max(s, lo), min(e, hi)
        if e <= at:
            continue
        if s > at:
            gaps.append((s - at, at, s))
        busy += e - max(s, at)
        at = e
    if hi > at:
        gaps.append((hi - at, at, hi))
    gaps.sort(reverse=True)
    labelled = []
    for length, s, e in gaps[:10]:
        mid = (s + e) / 2
        open_ops = [(b, n) for b, f, n in cpu if b <= mid <= f]
        labelled.append([max(open_ops)[1] if open_ops else "host outside any operation",
                         length])
    return dict(kernels=kernels, ops=ops, window_s=hi - lo, busy_s=busy, gaps=labelled)


def _has_ancestor(e, name):
    p = e.cpu_parent
    while p is not None:
        if p.name == name:
            return True
        p = p.cpu_parent
    return False


def _scalars(e):
    vals = getattr(e, "concrete_inputs", None) or []
    out = []
    for v in vals:
        if isinstance(v, (int, float, bool)):
            out.append(v)
        elif isinstance(v, str) and v.strip().lstrip("-").isdigit():
            out.append(int(v))
        elif isinstance(v, str) and v.strip() in ("True", "False"):
            out.append(v.strip() == "True")
    return out


def group_roofline(summary, op_names, dtype: str, counters, **kwargs):
    """Sum of the bound over the sum of the device time of the traced calls
    of `op_names`, in %, or None when the trace holds none of them."""
    from benchmark.counts.peaks import ELEMENT_BYTES, bound_s

    if summary is None:
        return None
    calls = [o for o in summary["ops"] if o["name"] in op_names]
    if not calls:
        return None
    bound = dev = 0.0
    for o in calls:
        fn = counters[o["name"]]
        scalars = o["scalars"][-3:] if len(o["scalars"]) >= 3 else None
        flops, nbytes = fn(o["shapes"], scalars, ELEMENT_BYTES[dtype], **kwargs)
        bound += bound_s(flops, nbytes, dtype)
        dev += o["device_s"]
    if dev <= 0:
        return None
    return 100.0 * bound / dev


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def breakdown(rec):
    """The device operations that took most time (the device span), the
    longest idle gaps by what the host was doing (the operator span)."""
    dev, ops = rec.get("trace_device"), rec.get("trace_ops")
    if not dev or not dev["kernels"]:
        return None
    per = {}
    for s, e, name in dev["kernels"]:
        per[name] = per.get(name, 0.0) + (e - s)
    top = sorted(per.items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[n[:160], v] for n, v in top],
            "idle_gaps": (ops or {}).get("gaps", [])[:10]}


def device_busy(rec):
    """(busy seconds, window seconds) of the device span: the union of its
    kernels' intervals, and its kept steps on the host clock."""
    dev, span = rec.get("trace_device"), rec.get("trace_span")
    if not dev or not dev["kernels"] or not span:
        return None
    return dev["busy_s"], span[1] - span[0]
