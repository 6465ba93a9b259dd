"""Time kernels 7 and 8 (the splats) on the card, and variants of their tiles.

    python -m pfnl_tpu_torch.ops.cuda.profile_splats [--against LIB] [--variants]

For each case of SPLAT_CASES (the shapes the Y families and FRVSR's HR
grid give the kernels: four serving windows' worth, and the one frame a
recurrent step splats), in bf16, it prints each kernel's time two ways:
- `events`: CUDA events around calls made back to back, as every kernel
  time of chip_smoke.py is read.  A call then costs the larger of its
  device time and the host time of its call, so a kernel faster than its
  ctypes call reads as the host's rate;
- `device`: the same calls queued behind a sleep kernel that holds the
  stream until the host has enqueued them all (`device_time_ms`), so only
  device time is counted.
It times the wrapper (`bounded_splat`, `spmc_splat`) and the library's C
entry by one ctypes call, and with --against the same entry of another
build of the library (an earlier commit's `build/libpfnl_kernels.so`) by
the same function, in the order this, other, other, this.

--variants builds variants of the two kernels, each a one- or two-line edit
of the committed sources that undoes one design choice (VARIANTS), into
its own library under build/splat_variants/, all nvcc processes started
together, beside `base`, the unedited sources built the same way.  Each is
checked against the plain version (but `no classes`, which races by
design and only shows what the class schedule costs) and timed by device
time, in the order base, variants, variants reversed, base.

The last line is one JSON object with every time printed.
"""

import argparse
import ctypes
import json
import os
import shutil
import subprocess
import sys
import time

import torch

from pfnl_tpu_torch.ops.cuda import _build

H, W = 180, 320
# (kernel, caller, (b, c, h, w) of the image, flow bound R)
SPLAT_CASES = [("bounded_splat", "VESPCN", (12, 1, H, W), 2),
               ("bounded_splat", "LTDVSR", (20, 1, H, W), 1),
               ("bounded_splat", "MCResNet", (20, 1, H, W), 2),
               ("bounded_splat", "FRVSR HR grid", (4, 3, 4 * H, 4 * W), 1),
               ("bounded_splat", "FRVSR serving", (1, 3, 4 * H, 4 * W), 1),
               ("spmc_splat", "DRVSR", (12, 1, H, W), 2)]
TOL = 2e-2  # bf16: max |kernel - plain| / max |plain|
REPS = 20   # calls a timing

SPLAT_FILES = ("bounded_splat.cu", "spmc_splat.cu", "splat_tile.cuh")
K7_TILES = "return c == 1 ? 4 : 1;"
K7_SHAPE, K8_SHAPE = "TH = 16, TW = 64, NT = 128;", "TH = 16, TW = 32, NT = 128;"
# name -> (kernels it changes, [(file, committed text, replacement)])
VARIANTS = {
    "k7 one tile at C=1": (("bounded_splat",), [("bounded_splat.cu", K7_TILES, "return 1;")]),
    "k7 two tiles at C=3": (("bounded_splat",), [
        ("bounded_splat.cu", K7_TILES, "return c == 1 ? 4 : c == 3 ? 2 : 1;")]),
    "k7 256 threads": (("bounded_splat",), [
        ("bounded_splat.cu", K7_SHAPE, "TH = 16, TW = 64, NT = 256;")]),
    "k7 TH 8": (("bounded_splat",), [("bounded_splat.cu", K7_SHAPE, "TH = 8, TW = 64, NT = 128;")]),
    "k7 TW 32": (("bounded_splat",), [
        ("bounded_splat.cu", K7_SHAPE, "TH = 16, TW = 32, NT = 128;")]),
    "k8 two tiles": (("spmc_splat",), [
        ("spmc_splat.cu", "return (size_t)HTH * HTW", "return (size_t)2 * HTH * HTW"),
        ("spmc_splat.cu", "reinterpret_cast<T*>(acc + HTH * HTW)",
         "reinterpret_cast<T*>(acc + 2 * HTH * HTW)"),
        ("spmc_splat.cu", "zero_tile<NT>(acc, HTH * HTW)", "zero_tile<NT>(acc, 2 * HTH * HTW)"),
        ("spmc_splat.cu", "for_each_class<NT, 1>", "for_each_class<NT, 2>"),
        ("spmc_splat.cu", "int li, int lj, int) {", "int li, int lj, int b) {"),
        ("spmc_splat.cu", "add_taps<1>(acc,", "add_taps<1>(acc + b * HTH * HTW,"),
        ("spmc_splat.cu", "store_rows<T, ASYNC, NT, 1>(out, acc, 0,",
         "store_rows<T, ASYNC, NT, 2>(out, acc, HTH * HTW,")]),
    "k8 TH 8": (("spmc_splat",), [("spmc_splat.cu", K8_SHAPE, "TH = 8, TW = 32, NT = 128;")]),
    "k8 256 threads": (("spmc_splat",), [
        ("spmc_splat.cu", K8_SHAPE, "TH = 16, TW = 32, NT = 256;")]),
    "no classes": (("bounded_splat", "spmc_splat"), [
        ("bounded_splat.cu", K7_TILES, "return 1;"),
        ("bounded_splat.cu", "oy, ox, 2 * r + 2, [&]", "oy, ox, 1, [&]"),
        ("spmc_splat.cu", "oy, ox, 2 * r + 1, [&]", "oy, ox, 1, [&]")]),
    "element-wise write-out": (("bounded_splat", "spmc_splat"), [
        ("splat_tile.cuh", "&& (at & 3) == 0) {", "&& false) {")]),
}
RACY = ("no classes",)


def events_ms(fn, reps=REPS):
    """Mean milliseconds a call over `reps` calls back to back, by CUDA
    events (host time included where it exceeds device time)."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_time_ms(fn, reps=REPS):
    """Mean device milliseconds per call over `reps` calls, by CUDA events,
    with the stream held by a sleep kernel while the host enqueues them:
    a kernel that takes less than its wrapper's host time a call would
    otherwise read as the host's rate.  The sleep is doubled until it
    outlasts the enqueue.  For a few launches a call: a function that
    launches hundreds fills the launch queue behind the sleep."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    cycles = int(2e9 * (2 * reps * (time.perf_counter() - t0) + 1e-3))  # at most 2 GHz
    events = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    for _ in range(4):
        events[0].record()
        torch.cuda._sleep(cycles)
        events[1].record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3
        events[2].record()
        torch.cuda.synchronize()
        if events[0].elapsed_time(events[1]) > host_ms:
            return events[1].elapsed_time(events[2]) / reps
        cycles *= 2
    raise RuntimeError("device_time_ms: the host kept falling behind the sleep")


def splat_inputs(shape, r, gen):
    """Seeded float32 image [b,h,w,c] and flow [b,h,w,2] with |uv| <= r."""
    b, c, h, w = shape
    im = torch.rand((b, h, w, c), generator=gen, device="cuda")
    uv = (torch.rand((b, h, w, 2), generator=gen, device="cuda") * 2 - 1) * r
    return im, uv


def plain(kernel, im, uv, r):
    from pfnl_tpu_torch.ops.warp import forward_warp_local_ref, forward_warp_local_spmc
    if kernel == "bounded_splat":
        return forward_warp_local_ref(im, uv, r)
    return forward_warp_local_spmc(im, uv, 4, r)


def wrapper(kernel, im, uv, r):
    from pfnl_tpu_torch.ops.cuda.bounded_splat import bounded_splat
    from pfnl_tpu_torch.ops.cuda.spmc_splat import spmc_splat
    if kernel == "bounded_splat":
        return bounded_splat(im, uv, r)
    return spmc_splat(im, uv, 4, r)


def entry(lib, kernel, im, uv, r):
    """The kernel's C entry in the ctypes library `lib`, by one call (no
    wrapper checks); raises on a CUDA error."""
    b, h, w, c = im.shape
    sfx = _build.suffix(im.dtype)
    if kernel == "bounded_splat":
        out = torch.empty_like(im)
        args = (im, uv, out, b, h, w, c, r)
    else:
        out = torch.empty((b, 4 * h, 4 * w, 1), dtype=im.dtype, device=im.device)
        args = (im, uv, out, b, h, w, r)
    fn = getattr(lib, f"pfnl_{kernel}_{sfx}")
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p if isinstance(a, torch.Tensor) else ctypes.c_int
                       for a in args] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args],
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"pfnl_{kernel}_{sfx}: CUDA error {err}")
    return out


def rel_err(got, ref):
    return ((got.float() - ref.float()).abs().max() / ref.float().abs().max()).item()


def build_variants(names):
    """Build `base` and each variant into build/splat_variants/<i>/lib.so;
    returns {name: ctypes library}.  Raises if an edit no longer matches
    the committed sources or a build fails."""
    root = os.path.join(_build.BUILD, "splat_variants")
    shutil.rmtree(root, ignore_errors=True)
    nvcc, procs = _build.tool("nvcc"), {}
    for i, name in enumerate(("base",) + tuple(names)):
        d = os.path.join(root, str(i))
        os.makedirs(d)
        for f in SPLAT_FILES:
            text = open(os.path.join(_build.CSRC, f)).read()
            for ef, old, new in ([] if name == "base" else VARIANTS[name][1]):
                if ef == f:
                    if text.count(old) != 1:
                        raise RuntimeError(f"variant {name!r}: {old!r} is not once in {f}")
                    text = text.replace(old, new)
            with open(os.path.join(d, f), "w") as fh:
                fh.write(text)
        cmd = [nvcc, *_build.NVCC_FLAGS, "-I", _build.CSRC, "-shared", "-o",
               os.path.join(d, "lib.so"), os.path.join(d, "bounded_splat.cu"),
               os.path.join(d, "spmc_splat.cu")]
        procs[name] = (d, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (d, proc) in procs.items():
        out = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name!r}: nvcc failed\n{out}")
        libs[name] = ctypes.CDLL(os.path.join(d, "lib.so"))
    return libs


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--against", help="another build of libpfnl_kernels.so, timed beside this one")
    ap.add_argument("--variants", action="store_true", help="build and time VARIANTS")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("profile_splats: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    _build.build()
    this = ctypes.CDLL(_build.LIB)
    other = ctypes.CDLL(os.path.abspath(args.against)) if args.against else None
    variants = build_variants(VARIANTS) if args.variants else {}
    gen = torch.Generator(device="cuda").manual_seed(3)
    summary = []
    for kernel, caller, shape, r in SPLAT_CASES:
        im32, uv32 = splat_inputs(shape, r, gen)
        im, uv = im32.bfloat16(), uv32.bfloat16()
        ref = plain(kernel, im, uv, r)
        row = {"kernel": kernel, "case": caller, "shape": list(shape), "r": r}
        fns = {"wrapper": lambda: wrapper(kernel, im, uv, r),
               "entry": lambda: entry(this, kernel, im, uv, r)}
        if other is not None:
            fns["other entry"] = lambda: entry(other, kernel, im, uv, r)
        for name, fn in fns.items():
            err = rel_err(fn(), ref)
            if err > TOL:
                raise RuntimeError(f"{name} {kernel} {caller}: max_rel_err {err:.3e} > {TOL}")
        order = ["entry", "other entry", "other entry", "entry"] if other else ["entry", "entry"]
        for how, clock in (("events", events_ms), ("device", device_time_ms)):
            t = {"wrapper": [clock(fns["wrapper"]), clock(fns["wrapper"])]}
            for name in order:
                t.setdefault(name, []).append(clock(fns[name]))
            row[how] = t
            print(f"[{how}] {kernel} ({caller}) bf16 {list(shape)} R={r}: "
                  + "; ".join(f"{k} {', '.join(f'{x:.4f}' for x in v)} ms" for k, v in t.items()),
                  flush=True)
        names = [n for n in variants if n == "base" or kernel in VARIANTS[n][0]]
        if names:
            for n in names:
                got = entry(variants[n], kernel, im, uv, r)
                if n not in RACY and rel_err(got, ref) > TOL:
                    raise RuntimeError(f"variant {n!r} {caller} disagrees with the plain version")
            t = {n: [] for n in names}
            for n in names + names[::-1]:
                t[n].append(device_time_ms(lambda: entry(variants[n], kernel, im, uv, r)))
            row["variants"] = t
            for n in names:
                print(f"[variant] {kernel} ({caller}) {n}: device {sum(t[n]) / 2:.4f} ms "
                      f"({t[n][0]:.4f}, {t[n][1]:.4f}), {sum(t[n]) / sum(t['base']):.3f}x base",
                      flush=True)
        summary.append(row)
    print(json.dumps({"card": card, "cases": summary}))


if __name__ == "__main__":
    main()
