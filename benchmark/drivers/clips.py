"""Clip serving through the program's Predictor, closed loop, one client.

The client submits one clip, `Predictor.test_video_lr`, and the next when
that call returns, as `testvideos` walks a dataset directory.  Clips are LR
uint8 frames in an in-memory frame store: each is the first L frames of one
of the traffic's seeded scenes, L cycling through every length of
`clip_frames` (inclusive), each cycle in an order drawn from the seed, so
every seed serves the same mix.  The sink is the benchmark's own: it
timestamps each HR frame as the Predictor hands it over and keeps the
frames the output check compares (each clip's first and last frame and
one between, drawn from the seed).

After the window: the reference (benchmark/reference/<model>.py, found by
the configuration's "model" before anything is set up), on the clips of a
sample drawn from the seed that holds the longest clip completed, computes
each kept frame from the same LR frames (its window edge-clamped, the LR
edge-padded to the reference's LR_MULTIPLE, its `serve`, the HR cropped
back) in float32, and the check compares what the sink received with it:
the RMS gap of each frame in uint8 levels, the worst frame's reported.
"""

import contextlib
import gc
import io
import os
import time
import traceback

import numpy as np
import torch

from benchmark import core, scenes, weights
from benchmark.reference.ops import FLOAT32, Precision, clamped_window, pad_to_multiple

TRACE_CLIPS_MAX = 400  # a traced run serves past its window until both spans are done
SERVING = ("LR_MULTIPLE", "serve")  # what the clips' check calls of a reference module

class ClipStore:
    """Frame store of the clips in flight: directory -> list of uint8 frames."""

    def __init__(self):
        self.dirs = {}

    def add(self, directory, frames):
        self.dirs[directory] = frames

    def drop(self, directory):
        self.dirs.pop(directory, None)

    def list(self, directory):
        return [f"{directory}/{i:04d}.png" for i in range(len(self.dirs.get(directory, ())))]

    def read(self, path):
        directory, name = path.rsplit("/", 1)
        return self.dirs[directory][int(name[:4])]


class Sink:
    """Counts and timestamps HR frames; keeps those of `keep` for the check."""

    def __init__(self):
        self.times, self.kept = [], {}
        self.clip, self.keep = None, ()

    def begin(self, clip, keep):
        self.clip, self.keep = clip, keep

    def write(self, path, img):
        self.times.append(time.perf_counter())
        j = int(os.path.basename(path)[:4])
        if j in self.keep:
            self.kept[(self.clip, j)] = img


def plan(traffic, seed, n):
    """(length, scene) of clips 0..n-1: every length of the range once a
    cycle, each cycle's order a permutation drawn from the seed."""
    lo, hi = traffic["clip_frames"]
    rng = np.random.default_rng(seed)
    lengths = []
    while len(lengths) < n:
        lengths += list(rng.permutation(np.arange(lo, hi + 1)))
    return [(int(L), i % traffic["scenes"]) for i, L in enumerate(lengths[:n])]


def kept_frames(seed, clip, length):
    rng = np.random.default_rng([seed, clip])
    return {0, length - 1, int(rng.integers(1, max(length - 1, 2)))}


def run(ctx):
    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    plain = core.reference(cfg, ctx.spec["root"], SERVING)
    from pfnl_tpu_torch.infer.predictor import Predictor

    h, w = traffic["lr_hw"]
    hi = traffic["clip_frames"][1]
    frames = scenes.make(traffic["scenes"], hi, h, w, ctx.sub_seed(1), dev).cpu().numpy()
    ctx.mark("scenes")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model, ref_weights = weights.build(cfg, getattr(torch, cfg["serve_dtype"]), dev,
                                       ctx.sub_seed(2))
    model.eval()
    ctx.mark("weights")
    store, sink = ClipStore(), Sink()
    predictor = Predictor(model, batch_windows=traffic["batch_windows"], source=store, sink=sink)
    order = plan(traffic, ctx.sub_seed(3), 100_000)
    log = io.StringIO()  # the Predictor's lines ("Save at", "spent") go here, not to stdout

    def serve(name, length, scene):
        store.add(f"{name}/blur{model.scale}", [frames[scene, k] for k in range(length)])
        try:
            return predictor.test_video_lr(name, name="sr")
        finally:
            store.drop(f"{name}/blur{model.scale}")

    with contextlib.redirect_stdout(log):
        for k in range(traffic["warm_clips"]):  # every shape the window uses, the pinned buffers
            sink.begin(-1, ())
            serve(f"warm{k}", hi, k % traffic["scenes"])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ctx.mark("warm-up")
        sink.times.clear()
        tracer = core.Tracer(traffic, ctx.trace)
        clips, failed = [], []
        t0 = time.perf_counter()
        setup_s = t0 - ctx.t_process
        deadline = t0 + ctx.seconds
        tracer.start()
        i = 0
        while time.perf_counter() < deadline or (tracer.pending() and i < TRACE_CLIPS_MAX):
            length, scene = order[i]
            sink.begin(i, kept_frames(ctx.sub_seed(4), i, length))
            ts = time.perf_counter()
            try:
                all_time = serve(f"c{i:05d}", length, scene)
                clips.append(dict(i=i, length=length, scene=scene, t0=ts, t1=time.perf_counter(),
                                  first_s=float(all_time[0])))
            except Exception:  # noqa: BLE001  (a clip that fails is counted and reported)
                failed.append(dict(i=i, error=traceback.format_exc()[-2000:]))
            tracer.step()
            i += 1
        tracer.stop()
        if dev.type == "cuda":
            torch.cuda.synchronize()
    t_end = t0 + ctx.seconds
    memory = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    done = [c for c in clips if c["t1"] <= t_end]
    rec = dict(kind="serve", setup_s=setup_s, window_s=ctx.seconds,
               frames=sum(1 for t in sink.times if t0 <= t <= t_end),
               clip_ms=[1e3 * (c["t1"] - c["t0"]) for c in done],
               first_batch_ms=[1e3 * c["first_s"] for c in done],
               attempted=i, failed=len(failed), errors=failed[:3], memory_peak_bytes=memory,
               config=cfg, traffic=traffic, **tracer.record())
    if rec["trace_span"] is not None:
        a, b, _ = rec["trace_span"]
        rec["trace_frames"] = sum(1 for t in sink.times if a <= t <= b)

    # the program's state goes before the reference runs
    del predictor, model
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    sample = check_sample(clips, traffic["check_clips"], ctx.sub_seed(5))
    rec["checked_frames"] = sum(len(kept_frames(ctx.sub_seed(4), c["i"], c["length"]))
                                for c in sample)
    rec["checks"] = {"worst_frame_rms": worst_frame_rms(
        plain, cfg, ref_weights, frames, sample, sink.kept, ctx.sub_seed(4), FLOAT32, dev)}
    return rec


def check_sample(clips, n, seed):
    """n clips drawn from the seed among those completed, the longest one
    (the first of that length) always among them."""
    if not clips:
        return []
    longest = max(clips, key=lambda c: (c["length"], -c["i"]))
    rest = [c for c in clips if c is not longest]
    rng = np.random.default_rng(seed)
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False) if rest else []
    return [longest] + [rest[k] for k in sorted(pick)]


def reference_frames(plain, cfg, ref_weights, clip_frames, centres, prec, device):
    """{centre: HR float32 [H,W,3] in [0, 255]} of the reference module
    `plain` (or of a control at another precision) for the windows centred
    on `centres`."""
    t, mult = cfg["num_frames"], plain.LR_MULTIPLE
    out = {}
    lr = torch.as_tensor(clip_frames, device=device).float() / 255.0   # [L,h,w,3]
    h0, w0 = lr.shape[1], lr.shape[2]
    for j in centres:
        x = pad_to_multiple(lr[clamped_window(lr.shape[0], j, t)][None], mult)
        with torch.no_grad():
            sr = plain.serve(ref_weights, x, cfg, prec)
        sr = sr[0, :h0 * cfg["scale"], :w0 * cfg["scale"]]
        out[j] = (sr.float() * 255.0).clamp(0, 255)
    return out


def worst_frame_rms(plain, cfg, ref_weights, frames, sample, kept, keep_seed, prec, device):
    """The largest, over the sample's kept frames, of the RMS gap in uint8
    levels between the frame served (the sink's, or for a control at `prec`
    its output rounded) and the float32 reference; inf where a kept frame
    is missing."""
    from benchmark.reference.ops import tf32_off

    tf32_off()
    worst = 0.0
    for c in sample:
        centres = sorted(kept_frames(keep_seed, c["i"], c["length"]))
        clip = frames[c["scene"], :c["length"]]
        ref = reference_frames(plain, cfg, ref_weights, clip, centres, FLOAT32, device)
        ctrl = (reference_frames(plain, cfg, ref_weights, clip, centres, prec, device)
                if prec is not FLOAT32 else None)
        for j in centres:
            if ctrl is not None:
                got = torch.round(ctrl[j])
            elif (c["i"], j) in kept:
                got = torch.as_tensor(kept[(c["i"], j)], device=device).float()
            else:
                return float("inf")
            if got.shape != ref[j].shape:
                return float("inf")
            worst = max(worst, float(torch.sqrt(torch.mean((got - ref[j]) ** 2))))
    return worst


def control(ctx, kind="fp8"):
    """The control's reading on this cell: the reference at the precision
    below the configuration's (fp8 for bf16) put in the program's place, on
    the clips the check would sample (no window: the same plan, from the
    seed)."""
    cfg, traffic, dev = ctx.config, ctx.traffic, ctx.device
    plain = core.reference(cfg, ctx.spec["root"], SERVING)
    h, w = traffic["lr_hw"]
    frames = scenes.make(traffic["scenes"], traffic["clip_frames"][1], h, w, ctx.sub_seed(1),
                         dev).cpu().numpy()
    _, ref_weights = weights.build(cfg, getattr(torch, cfg["serve_dtype"]), dev, ctx.sub_seed(2))
    order = plan(traffic, ctx.sub_seed(3), 64)
    clips = [dict(i=i, length=L, scene=s) for i, (L, s) in enumerate(order)]
    sample = check_sample(clips, traffic["check_clips"], ctx.sub_seed(5))
    return worst_frame_rms(plain, cfg, ref_weights, frames, sample, {}, ctx.sub_seed(4),
                           Precision(kind), dev)
