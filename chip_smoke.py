#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pfnl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its own lines; any failure raises and exits non-zero:

  1. the device: name, count, torch/CUDA versions, nvidia-smi name and
     power limit;
  2. build every kernel from csrc/ with nvcc; the build seconds and the
     ptxas register / shared-memory / spill report;
  3. each kernel against its plain PyTorch version at the main path's
     shapes (PFNL 7 frames, LR 180x320, batch 2), in float32 (TF32 off on
     the plain side) and in bfloat16, with the tolerance stated, and the
     time of each beside the plain version's (CUDA events, bf16);
  4. end to end through Predictor.test_video_truth: full-width PFNL
     (mf 64, 20 PFRBs, 7 frames, bf16, seeded random weights) on a seeded
     12-frame 720x1280 clip degraded on the device to 180x320, frames kept
     in memory.  Checks the output frames, the kernels' launch counts per
     forward batch, and the bf16 kernel path against the float32 plain
     path on the first window; prints HR frames/s and peak memory.

The second-to-last line is a JSON summary of the kernels; the last line is
{"ok": true, "device": {...}}.  There is no CPU fallback: without a CUDA
device the script fails before printing any result.
"""

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
B, T, H, W, C = 2, 7, 180, 320, 64      # phase 3 shapes: the main path's
CLIP_FRAMES, BATCH_WINDOWS = 12, 4      # phase 4: three forward batches of 4 windows
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # max |kernel - plain| / max |plain|
E2E_TOL = 2e-2                          # ||SR_bf16,kernels - SR_f32,plain|| / ||SR_f32,plain||
TPU_KERNEL = {
    "nonlocal_flash": "pfnl_tpu/ops/pallas/nonlocal_flash.py:103",
    "pfrb_a": "pfnl_tpu/ops/pallas/pfrb_pack.py:313",
    "pfrb_b": "pfnl_tpu/ops/pallas/pfrb_pack.py:330",
    "pfnl_tail": "pfnl_tpu/ops/pallas/pfnl_tail.py:187",
}
SOURCE = {
    "nonlocal_flash": "pfnl_tpu_torch/csrc/nonlocal_flash.cu",
    "pfrb_a": "pfnl_tpu_torch/csrc/pfrb.cu",
    "pfrb_b": "pfnl_tpu_torch/csrc/pfrb.cu",
    "pfnl_tail": "pfnl_tpu_torch/csrc/pfnl_tail.cu",
}


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def cuda_time_ms(fn, reps=3):
    """Mean milliseconds per call over `reps` calls, by CUDA events."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def phase_device():
    name = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(f"[1 device] {name} x{count}; torch {torch.__version__}, CUDA {torch.version.cuda}",
          flush=True)
    print(smi, flush=True)
    return name, count, smi


def phase_build():
    from pfnl_tpu_torch.ops.cuda import _build

    seconds = _build.build(force=True)
    print(f"[2 build] nvcc built {_build.LIB} from {len(_build.sources())} sources "
          f"in {seconds:.1f} s", flush=True)
    with open(_build.PTXAS_LOG) as f:
        for line in f:
            if "Compiling entry function" in line or "Used" in line or "spill" in line:
                print("  " + line.strip().replace("ptxas info    : ", ""))


def _rand(shape, gen, scale=1.0, dist="normal"):
    x = (torch.randn if dist == "normal" else torch.rand)(shape, generator=gen, device="cuda")
    return x * scale


def _glorot(shape, fan_in, fan_out, gen):
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=gen, device="cuda") * 2 - 1) * limit


def kernel_cases():
    """(name, flop, make_inputs(dtype) -> args, kernel, plain) for the four
    kernels at the main path's shapes.  Biases are non-zero so the checks
    cover them."""
    from pfnl_tpu_torch.ops.cuda.nonlocal_flash import nonlocal_flash
    from pfnl_tpu_torch.ops.cuda.pfnl_tail import pfnl_tail
    from pfnl_tpu_torch.ops.cuda.pfrb import pfrb_a, pfrb_b
    from pfnl_tpu_torch.ops.nonlocal_attn import nonlocal_attention_chunked
    from pfnl_tpu_torch.ops.pfrb_ref import pfnl_tail_ref, pfrb_a_ref, pfrb_b_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    n_pos, d = (H // 2) * (W // 2), 3 * T * 4
    theta = _rand((B, n_pos, d), gen, dist="uniform")    # s2d of LR frames in [0,1)
    g = _rand((B, n_pos, d), gen, 0.5)
    feat = _rand((B, T, H, W, C), gen, 0.5)
    w1 = _glorot((3, 3, C, C), 9 * C, 9 * C, gen)
    wfuse = _glorot((T, C, C), T * C, C, gen)
    w2f = _glorot((3, 3, C, C), 18 * C, 9 * C, gen)
    w2b = _glorot((3, 3, C, C), 18 * C, 9 * C, gen)
    b1, bfuse, b2 = (_rand((C,), gen, 0.1) for _ in range(3))
    wm1 = _glorot((3, 3, T * C, 48), 9 * T * C, 9 * 48, gen)
    km2 = _glorot((3, 3, 12, 12), 108, 108, gen)
    bm1, bm2 = _rand((48,), gen, 0.1), _rand((12,), gen, 0.1)

    def pfrb_b_inputs(dt):
        f = feat.to(dt)
        i1, base = pfrb_a_ref(f, w1, b1, wfuse, bfuse)
        return (f, i1, base, w2f, w2b, b2)

    hw = B * H * W
    return [
        ("nonlocal_flash", 2.0 * B * n_pos * n_pos * (d + d),
         lambda dt: (theta.to(dt), theta.to(dt), g.to(dt)),
         nonlocal_flash, nonlocal_attention_chunked),
        ("pfrb_a", hw * T * C * C * 2.0 * 10,
         lambda dt: (feat.to(dt), w1, b1, wfuse, bfuse), pfrb_a, pfrb_a_ref),
        ("pfrb_b", hw * (T + 1) * C * C * 2.0 * 9, pfrb_b_inputs, pfrb_b, pfrb_b_ref),
        ("pfnl_tail", hw * (T * C * 48 + 48 * 48) * 2.0 * 9,
         lambda dt: (feat.to(dt), wm1, bm1, km2, bm2), pfnl_tail, pfnl_tail_ref),
    ]


def _max_errs(got, ref):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    abs_err = max((a.float() - b.float()).abs().max().item() for a, b in zip(got, ref))
    scale = max(b.float().abs().max().item() for b in ref)
    return abs_err, abs_err / scale


def phase_kernels(card):
    results = {}
    for name, flop, make, kernel, plain in kernel_cases():
        res = {}
        for dt in (torch.float32, torch.bfloat16):
            key = str(dt).replace("torch.", "")
            args = make(dt)
            got = kernel(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            abs_err, rel_err = _max_errs(got, ref)
            ok = rel_err <= TOL[key]
            print(f"[3 kernel] {name} {key}: max_abs_err {abs_err:.3e}, max_rel_err "
                  f"{rel_err:.3e} (tolerance {TOL[key]:.0e} of max|plain|) "
                  f"{'ok' if ok else 'DISAGREES'}", flush=True)
            if not ok:
                fail(f"{name} {key} disagrees with its plain version")
            res[key] = abs_err
        args = make(torch.bfloat16)
        for fn in (kernel, plain):  # warm-up
            fn(*args)
        p1 = cuda_time_ms(lambda: plain(*args))
        k1 = cuda_time_ms(lambda: kernel(*args))
        k2 = cuda_time_ms(lambda: kernel(*args))
        p2 = cuda_time_ms(lambda: plain(*args))
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        print(f"[3 time] {name} bf16 [{B},{T},{H},{W}]: kernel {ms:.3f} ms "
              f"({flop / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.3f} ms "
              f"({flop / plain_ms / 1e9:.2f} TFLOP/s) on {card}", flush=True)
        results[name] = dict(max_abs_err=res["bfloat16"], max_abs_err_f32=res["float32"],
                             ms=ms, plain_ms=plain_ms)
    return results


def synthetic_clip(frames, h, w, seed):
    """Seeded smooth moving colour pattern + noise, uint8 [F,h,w,3]."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    phase = rng.random(3) * 6.28
    clip = np.empty((frames, h, w, 3), np.uint8)
    for t in range(frames):
        img = np.stack([0.5 + 0.4 * np.sin(2 * np.pi * (xx + 3 * t) / 97 + phase[c])
                        * np.cos(2 * np.pi * (yy + t) / 61 + phase[c]) for c in range(3)], -1)
        img += 0.05 * rng.random((h, w, 3), dtype=np.float32)
        clip[t] = np.round(np.clip(img, 0, 1) * 255)
    return clip


def phase_end_to_end(card):
    from pfnl_tpu_torch.infer.predictor import MemoryFrames, Predictor, _clipped_windows
    from pfnl_tpu_torch.models.pfnl import PFNL
    from pfnl_tpu_torch.ops.cuda import KERNELS, launches, reset_launches

    model = PFNL(dtype=torch.bfloat16, generator=torch.Generator().manual_seed(SEED))
    model = model.to("cuda").eval()
    hr_h, hr_w = H * 4, W * 4
    clip = synthetic_clip(CLIP_FRAMES, hr_h, hr_w, SEED)
    mem = MemoryFrames({f"clip/truth/{i:04d}.png": clip[i] for i in range(CLIP_FRAMES)})
    pred = Predictor(model, batch_windows=BATCH_WINDOWS, source=mem, sink=mem)
    n_batches = -(-CLIP_FRAMES // BATCH_WINDOWS)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    chunk_s = pred.test_video_truth("clip", name="sr")
    wall = time.perf_counter() - t0
    counts = {k: launches[k] for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()

    want = {"nonlocal_flash": 1, "pfrb_a": model.num_blocks, "pfrb_b": model.num_blocks,
            "pfnl_tail": 1}
    per_batch = {k: counts[k] / n_batches for k in KERNELS}
    print(f"[4 e2e] launches over {n_batches} forward batches: {counts}; per batch {per_batch}",
          flush=True)
    if any(counts[k] != want[k] * n_batches for k in KERNELS):
        fail(f"launch counts {counts} != {want} x {n_batches} batches")
    outs = mem.list("clip/sr")
    if len(outs) != CLIP_FRAMES:
        fail(f"{len(outs)} SR frames written, want {CLIP_FRAMES}")
    for p in outs:
        img = mem.read(p)
        if img.shape != (hr_h, hr_w, 3) or img.dtype != np.uint8:
            fail(f"{p}: {img.shape} {img.dtype}, want ({hr_h}, {hr_w}, 3) uint8")
    # steady state: the batches after the first
    fps = (CLIP_FRAMES - BATCH_WINDOWS) / float(np.sum(chunk_s[1:]))
    print(f"[4 e2e] {CLIP_FRAMES} HR frames {hr_h}x{hr_w} in {wall:.2f} s wall "
          f"(batches {', '.join(f'{s:.3f}' for s in chunk_s)} s); steady {fps:.2f} HR frames/s; "
          f"peak memory {peak / 2**30:.2f} GiB on {card}", flush=True)

    # the first window: bf16 kernels vs the float32 plain path, TF32 off
    lrs = pred._degrade_video(clip.astype(np.float32) / 255.0)
    x = torch.from_numpy(lrs[_clipped_windows(CLIP_FRAMES, model.num_frames)[0]][None]).cuda()
    ref_model = PFNL(dtype=torch.float32, num_blocks=model.num_blocks).cuda().eval()
    ref_model.load_state_dict(model.state_dict())
    with torch.inference_mode():
        got = model(x)
        ref = ref_model(x, plain=True)
    torch.cuda.synchronize()
    if got.shape != (1, 1, hr_h, hr_w) + (3,) or not torch.isfinite(got).all():
        fail(f"SR of the first window: shape {tuple(got.shape)} or non-finite values")
    rel = ((got - ref).norm() / ref.norm()).item()
    max_abs = (got - ref).abs().max().item()
    print(f"[4 e2e] first window, bf16 kernels vs f32 plain: rel L2 err {rel:.3e} "
          f"(tolerance {E2E_TOL:.0e}), max abs err {max_abs:.3e}, max|SR| "
          f"{ref.abs().max().item():.3e}", flush=True)
    if rel > E2E_TOL:
        fail("bf16 kernel path disagrees with the f32 plain path")
    return counts


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke runs only on a CUDA GPU")
    import pfnl_tpu_torch  # noqa: F401  (fails here outside a checkout of the repo)

    # the plain side of every float32 comparison runs in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name, count, _ = phase_device()
    phase_build()
    results = phase_kernels(name)
    counts = phase_end_to_end(name)

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "pfnl_tpu"))
    if leaked:
        fail(f"the port loaded JAX-side modules: {leaked[:5]}")

    kernels = [dict(name=k, route="cuda", source=SOURCE[k], replaces=TPU_KERNEL[k],
                    launches=counts[k], max_abs_err=results[k]["max_abs_err"],
                    ms=results[k]["ms"], plain_ms=results[k]["plain_ms"])
               for k in TPU_KERNEL]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
