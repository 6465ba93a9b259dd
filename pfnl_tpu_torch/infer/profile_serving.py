"""Where the time goes in a serving batch of PFNL, a Y family or DUF on a CUDA device.

    python -m pfnl_tpu_torch.infer.profile_serving [--families pfnl vespcn drvsr duf ...]
        [--export]

For each family at full width, bf16, seeded random weights (for DUF also
seeded BatchNorm statistics), one batch of `--batch` windows at LR `--lr`
(default 180x320 -> 720x1280), it prints:

  * forward ms on the kernel path and on the plain path (`plain=True`):
    CUDA events around `model(x)`, mean of 5 (kernel) or 3 (plain) calls
    after a warm-up;
  * serve ms (`infer.predictor.serve`: `serve_rgb` for a Y family, the
    model's RGB output for PFNL and DUF; events, mean of 5) and the
    device's busy share of it: the self device time of every CUDA kernel
    `torch.profiler` records over two `serve` calls, halved, over the
    event time of one call;
  * the host's share of a `serve` call on the host clock, the mean of 3
    after a synchronize: the seconds until it returns (enqueueing its
    work) beside those until the device is done.  The pipelined Predictor
    can keep the device busy only while the first is well below the
    second;
  * that kernel time split by kernel name into the port's kernels (PFNL's
    attention, PFRBs and tail; the splats; DUF's dense block and conv),
    convolutions (cuDNN, CUTLASS, GEMM), layout copies (NCHW<->NHWC,
    copies, transposes) and the rest (elementwise), and the five largest
    kernels;
  * the Predictor's tail of one batch on the host clock, the second of two
    passes: uint8 rounding on the card and the download of the uint8 frames
    (to pageable memory here, pinned in the Predictor), then the in-memory
    sink per frame (the Predictor overlaps this tail with the next batch's
    forward).

With --export, for each family the loaded AOT artifact of its serving
program (infer/export.py) beside eager `serve` on the same batch: event
ms (eager, artifact, artifact, eager, 5 calls each), the host's enqueue
and the device's done ms of a call, the device busy ms, the CUDA kernels
whose time or count a call differs by (torch.profiler, two calls), and the
operators the artifact runs a different number of times than eager serve
(the nodes the export added or dropped, by the profiler's host events).
"""

import argparse
import subprocess
import time

import torch
from torch.profiler import ProfilerActivity, profile

from pfnl_tpu_torch.infer.predictor import MemoryFrames, serve, to_uint8
from pfnl_tpu_torch.models import MODEL_REGISTRY

Y_FAMILIES = ("vespcn", "drvsr", "mcresnet", "ltdvsr")
FAMILIES = ("pfnl",) + Y_FAMILIES + ("duf",)
# substrings of the port's kernel entry names (csrc/*.cu)
PORT_KERNELS = ("nonlocal_flash", "pfrb_", "tail_", "splat", "duf_")


def seeded_model(family: str, dtype: torch.dtype, seed: int, device="cuda", **kwargs):
    """A family at full width (or as `kwargs` set it): the port's random
    init from `seed`, then every bias, PReLU slope and BatchNorm offset
    (flax starts them at 0) drawn from N(0, 0.05^2), so that a bias bug
    cannot hide.  DUF's BatchNorms also get gamma 1 + N(0, 0.05^2) and
    seeded statistics, moving_mean N(0, 0.1^2) and moving_variance
    U(0.5, 1.5), which keep the activations O(1) (the init's variance of 0
    makes them about 1e17)."""
    model = MODEL_REGISTRY[family](dtype=dtype, generator=torch.Generator().manual_seed(seed),
                                   **kwargs)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("bias", "alpha", ".b", ".beta")):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.05)
            elif name.endswith(".gamma"):
                p.copy_(1 + torch.randn(p.shape, generator=gen) * 0.05)
        for name, b in model.named_buffers():
            if name.endswith(".moving_mean"):
                b.copy_(torch.randn(b.shape, generator=gen) * 0.1)
            elif name.endswith(".moving_variance"):
                b.copy_(torch.rand(b.shape, generator=gen) + 0.5)
    return model.to(device).eval()


def _event_ms(fn, reps):
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _category(key: str) -> str:
    k = key.lower()
    layout = any(t in k for t in ("nchwtonhwc", "nhwctonchw"))
    if any(t in k for t in PORT_KERNELS):
        return "port kernel"
    if any(t in k for t in ("conv", "xmma", "cutlass", "gemm", "cudnn")) and not layout:
        return "convolution"
    if layout or any(t in k for t in ("copy", "transpose")):
        return "layout/copy"
    return "elementwise/other"


def profile_family(family: str, batch: int, h: int, w: int, seed: int = 0):
    model = seeded_model(family, torch.bfloat16, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand((batch, model.num_frames, h, w, 3), generator=gen, device="cuda")
    kw = model.serve_kwargs if model.y_channel else {}
    with torch.inference_mode():
        model(x, **kw)
        model(x, plain=True, **kw)
        serve(model, x)
        torch.cuda.synchronize()
        fwd = _event_ms(lambda: model(x, **kw), 5)
        plain_fwd = _event_ms(lambda: model(x, plain=True, **kw), 3)
        srv = _event_ms(lambda: serve(model, x), 5)
        enqueue = done = 0.0
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            serve(model, x)
            t1 = time.perf_counter()
            torch.cuda.synchronize()
            enqueue, done = enqueue + (t1 - t0) / 3, done + (time.perf_counter() - t0) / 3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(2):
                serve(model, x)
            torch.cuda.synchronize()
        kern = [e for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in kern) / 2 / 1e3  # us over 2 calls
        cats = {}
        for e in kern:
            cats[_category(e.key)] = cats.get(_category(e.key), 0) + e.self_device_time_total

        dev = serve(model, x)
        for _ in range(2):  # the second pass is timed: the first allocates
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            arr = to_uint8(dev).cpu().numpy()
            t1 = time.perf_counter()
            sink = MemoryFrames()
            for j in range(arr.shape[0]):
                sink.write(f"o/{j:04d}.png", arr[j].copy())
            t2 = time.perf_counter()

    total = sum(cats.values()) or 1.0
    print(f"== {family}: {batch} windows, LR {h}x{w}, bf16; forward {fwd:.3f} ms (plain path "
          f"{plain_fwd:.3f} ms), serve {srv:.3f} ms, device busy {busy_ms:.3f} ms "
          f"({busy_ms / srv:.1%})", flush=True)
    print(f"host: serve returns after {1e3 * enqueue:.3f} ms, the device is done after "
          f"{1e3 * done:.3f} ms", flush=True)
    print("kernel time: " + ", ".join(f"{c} {v / total:.1%}" for c, v in
                                      sorted(cats.items(), key=lambda kv: -kv[1])), flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:5]:
        print(f"  {e.self_device_time_total / total:6.1%} {e.self_device_time_total / 2e3:8.3f} ms"
              f"  {e.key[:80]}", flush=True)
    print(f"tail of one batch: uint8 on the card + download {1e3 * (t1 - t0):.1f} ms, sink "
          f"{1e3 * (t2 - t1):.1f} ms", flush=True)


def _calls(fn):
    """({kernel: (device ms, launches)}, {host operator: calls}), a call's
    mean over two under torch.profiler."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            fn()
        torch.cuda.synchronize()
    kern, ops = {}, {}
    for e in prof.key_averages():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            kern[e.key] = (e.self_device_time_total / 2e3, e.count / 2)
        elif e.key.startswith(("aten::", "pfnl::")):
            ops[e.key] = e.count / 2
    return kern, ops


def _host_ms(fn):
    """(ms until a call returns, ms until the device is done), mean of 3."""
    enqueue = done = 0.0
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        enqueue, done = enqueue + (t1 - t0) / 3, done + (time.perf_counter() - t0) / 3
    return 1e3 * enqueue, 1e3 * done


def profile_export(family: str, batch: int, h: int, w: int, seed: int = 0):
    from pfnl_tpu_torch.infer.export import export_model, load_exported

    model = seeded_model(family, torch.bfloat16, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand((batch, model.num_frames, h, w, 3), generator=gen, device="cuda")
    fn = load_exported(export_model(model, batch, model.num_frames, (h, w), model_name=family))
    with torch.inference_mode():
        runs = {"eager": lambda: serve(model, x), "artifact": lambda: fn(x)}
        for f in runs.values():
            f()
        ms = {k: [] for k in runs}
        for k in ("eager", "artifact", "artifact", "eager"):
            ms[k].append(_event_ms(runs[k], 5))
        host = {k: _host_ms(f) for k, f in runs.items()}
        prof = {k: _calls(f) for k, f in runs.items()}
    busy = {k: sum(t for t, _ in prof[k][0].values()) for k in runs}
    print(f"== {family} export: {batch} windows, LR {h}x{w}, bf16; eager serve "
          f"{', '.join(f'{v:.3f}' for v in ms['eager'])} ms, artifact "
          f"{', '.join(f'{v:.3f}' for v in ms['artifact'])} ms; device busy eager "
          f"{busy['eager']:.3f} ms, artifact {busy['artifact']:.3f} ms", flush=True)
    for k, (enq, done) in host.items():
        print(f"host, {k}: a call returns after {enq:.3f} ms, the device is done after "
              f"{done:.3f} ms", flush=True)
    ke, ka = prof["eager"][0], prof["artifact"][0]
    diff = []
    for key in set(ke) | set(ka):
        (te, ce), (ta, ca) = ke.get(key, (0.0, 0)), ka.get(key, (0.0, 0))
        if ce != ca or abs(ta - te) > 0.01:
            diff.append((ta - te, ca - ce, ta, ca, key))
    print("kernels a call, artifact - eager (ms, launches; the artifact's ms, launches):",
          flush=True)
    for dt, dc, ta, ca, key in sorted(diff, key=lambda d: -abs(d[0]))[:12]:
        print(f"  {dt:+8.3f} ms {dc:+5.1f}  ({ta:.3f} ms, {ca:.1f})  {key[:90]}", flush=True)
    oe, oa = prof["eager"][1], prof["artifact"][1]
    ops = sorted(((oa.get(k, 0) - oe.get(k, 0), k) for k in set(oe) | set(oa)
                  if oa.get(k, 0) != oe.get(k, 0)), key=lambda d: -abs(d[0]))
    print("host operators a call, artifact - eager: " + ", ".join(
        f"{k} {d:+.1f}" for d, k in ops[:20]), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--families", nargs="+", default=list(Y_FAMILIES), choices=FAMILIES)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--lr", type=int, nargs=2, default=(180, 320), metavar=("H", "W"))
    ap.add_argument("--export", action="store_true",
                    help="the loaded AOT artifact of each family beside eager serve")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_serving needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    # TF32 off, as chip_smoke.py runs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for fam in args.families:
        (profile_export if args.export else profile_family)(fam, args.batch, *args.lr)


if __name__ == "__main__":
    main()
