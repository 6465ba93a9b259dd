"""Where the time goes in a PFNL training step on a CUDA device.

    python -m pfnl_tpu_torch.train.profile_training

The paper config (preset `pfnl`: batch 16, LR crop 32 / GT 128, 7 frames,
the "single" producer, Adam), full-width PFNL in float32 with seeded random
weights and biases, TF32 off, on pre-fetched uint8 batches made from a
numpy seed (no host pipeline), through `Trainer.step` on the kernel path
and on the plain path (`plain=True`).  For each it prints:

  * steps/s and ms a step over 10 steps after 3 warm-up steps, on the
    host clock, ending in a synchronize;
  * over 3 more steps under `torch.profiler`: the device's busy
    time a step (the self device time of every CUDA kernel, over the
    steps) and its share of the timed step (the profiler slows the host,
    so the profiled steps take longer), the kernel time split into the
    port's kernels by name (K5/K6, the PFRB backward: its data-gradient
    and weight-gradient kernels and their reduction; K2, K3, K4),
    convolutions (cuDNN, GEMM), layout copies and the rest
    (elementwise), and the eight largest kernels.
"""

import subprocess
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from pfnl_tpu_torch.config import preset
from pfnl_tpu_torch.infer.profile_serving import _category, seeded_model
from pfnl_tpu_torch.train.trainer import Trainer

WARM, TIMED, PROFILED = 3, 10, 3  # steps: warm-up, on the host clock, under the profiler


# the entry names of kernels 5 and 6 (csrc/pfrb_bwd.cu): cuDNN's own weight-gradient
# kernels are named "...wgrad...", so the port's are matched in full
PFRB_BWD = ("pfrb_bwd_", "bwd_a_data_kernel", "bwd_b_data_kernel", "wgrad_tf32_mma_kernel",
            "wgrad_partial_kernel", "wgrad_reduce_kernel")


def category(key: str) -> str:
    if any(n in key for n in PFRB_BWD):  # before pfrb_b: "pfrb_bwd" contains it
        return "K5/K6 pfrb backward"
    for name, label in (("pfrb_a", "K2 pfrb_a"), ("pfrb_b", "K3 pfrb_b"),
                        ("tail_", "K4 pfnl_tail"), ("nonlocal_flash", "K1 nonlocal_flash")):
        if name in key:
            return label
    return _category(key)


def batches(cfg, count: int, seed: int):
    """`count` uint8 batches as the single producer hands them over."""
    rng = np.random.default_rng(seed)
    size = cfg.in_size * cfg.scale
    shape = (cfg.batch_size, cfg.num_frames, size, size, 3)
    return [{"gt": rng.integers(0, 256, shape, dtype=np.uint8)} for _ in range(count)]


def profile_path(cfg, plain: bool, seed: int = 0):
    model = seeded_model("pfnl", torch.float32, seed).train()
    tr = Trainer(cfg, model=model, device="cuda", plain=plain)
    data = batches(cfg, WARM + TIMED + PROFILED, seed)
    it = iter(range(len(data)))

    def step():
        i = next(it)
        return tr.step(data[i], tr.step_generator(i))

    for _ in range(WARM):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(TIMED):
        step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / TIMED
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED):
            step()
        torch.cuda.synchronize()
    prof_wall = (time.perf_counter() - t0) / PROFILED
    # device kernels only: a user annotation's span (Optimizer.step#Adam.step) holds the
    # kernels it launched, which are counted on their own
    kern = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False) and "#" not in e.key]
    busy = sum(e.self_device_time_total for e in kern) / PROFILED / 1e3  # us -> ms a step
    cats = {}
    for e in kern:
        cats[category(e.key)] = cats.get(category(e.key), 0) + e.self_device_time_total
    total = sum(cats.values()) or 1.0
    path = "plain" if plain else "kernels"
    print(f"== {path}: {1 / wall:.3f} steps/s ({1e3 * wall:.3f} ms a step over {TIMED} steps); "
          f"device busy {busy:.3f} ms a step over {PROFILED} profiled steps "
          f"({busy / (1e3 * wall):.1%} of the timed step; the profiled steps took "
          f"{1e3 * prof_wall:.3f} ms each)", flush=True)
    print("kernel time: " + ", ".join(f"{c} {v / total:.1%} ({v / PROFILED / 1e3:.3f} ms)"
                                      for c, v in sorted(cats.items(), key=lambda kv: -kv[1])),
          flush=True)
    for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:8]:
        t = e.self_device_time_total
        print(f"  {t / total:6.1%} {t / PROFILED / 1e3:8.3f} ms  {e.count // PROFILED:3d}x  "
              f"{e.key[:90]}", flush=True)
    del tr, model
    torch.cuda.empty_cache()


def main():
    if not torch.cuda.is_available():
        raise SystemExit("profile_training needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = preset("pfnl", reload=False)
    for plain in (False, True):
        profile_path(cfg, plain)


if __name__ == "__main__":
    main()
