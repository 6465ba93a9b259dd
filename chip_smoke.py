#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (pfnl_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its own lines; any failure raises and exits non-zero:

  1. the device: name, count, torch/CUDA versions, nvidia-smi name and
     power limit;
  2. build every kernel from csrc/ with nvcc; the build seconds and the
     ptxas register / shared-memory / spill report; the HMMA (tensor-core
     mma) instructions in each kernel entry's SASS (cuobjdump -sass),
     failing if a bf16 entry of kernel 1, 2, 3, 4, 9 or 10 has none (all
     six run on the tensor cores in bf16), if a float32 entry of kernel
     5 or 6 (3xTF32 on the tensor cores: HMMA.1688.F32.TF32) has none or
     spills, or if an entry of kernel 7 or 8 (the splat tiles) spills;
  3. each kernel against its plain PyTorch version at the main path's
     shapes (PFNL 7 frames, LR 180x320, batch 2), in float32 (TF32 off on
     the plain side) and in bfloat16, with the tolerance stated, and the
     time of each beside the plain version's (CUDA events, bf16); kernels 1,
     2, 3 and 4 bitwise equal over two launches, kernel 1's time over
     scaled_dot_product_attention's; then
     the two splat kernels, 7 and 8, at their callers' shapes (K7: VESPCN
     [12,1,180,320] R=2, LTDVSR [20,1,180,320] R=1, MCResNet
     [20,1,180,320] R=2, FRVSR's HR grid [4,3,720,1280] R=1 and its
     serving step [1,3,720,1280] R=1; K8: DRVSR [12,180,320] x4 R=2), each
     in float32 and bfloat16 within TOL, bitwise equal over two launches,
     with its
     achieved GB/s and its time over its bound, timed as every kernel here
     (back to back, so a call's host time counts where it exceeds the
     kernel's), and beside it the kernel's device time alone
     (profile_splats.device_time_ms: a sleep kernel holds the stream while
     the host enqueues the calls);
  4. end to end through Predictor.test_video_truth: full-width PFNL
     (mf 64, 20 PFRBs, 7 frames, bf16, seeded random weights) on a seeded
     24-frame 720x1280 clip degraded on the device to 180x320, frames kept
     in memory.  Checks the output frames, the kernels' launch counts per
     forward batch, and the bf16 kernel path against the float32 plain
     path on the first window; prints delivered HR frames/s (the pipelined
     Predictor, steady) beside the forward's alone (CUDA events around
     `serve` on one batch) and peak memory;
  5. training at the paper config (batch 16, LR crop 32 / GT 128, 7
     frames, float32):
     a. kernels 5 and 6 (the PFRB backward) against their plain versions
        at the training shape [16,7,32,32,64] and at [2,7,180,320,64], in
        float32 and bfloat16, with their times and TFLOP/s beside the plain
        versions' and their weight gradients bitwise equal over two
        launches; in float32 also the 3xTF32 bound (three TF32 products a
        float32 product over 495 TFLOP/s) beside the float32 CUDA-core one
        (over 67), and the time of cuDNN's conv backward for the same
        function (aten.convolution_backward, all three gradients, TF32 off:
        kernel 6 one call plus the add of g; kernel 5 a composite of two
        calls, the frames and the base, plus the frame sum), with its error
        against plain as a note, not a check (cuDNN's float32 weight
        gradient may take FFT routes about 2e-4 off);
     b. one fixed batch through full-width PFNL: the kernel path's loss and
        every parameter's gradient against pure autograd on the plain
        path (TF32 off), worst relative L2 error per parameter;
     c. Trainer.fit over seeded in-memory clips through TrainPipeline: the
        kernels' launches per step, finite losses, steady steps/s and peak
        memory, then the same steps on the plain path;
  6. Y-channel serving end to end, for each of VESPCN, DRVSR, MCResNet and
     LTDVSR at full width (bf16, seeded random weights with non-zero
     biases and PReLU slopes): Predictor.test_video_lr over the 24-frame
     clip degraded on the device to 180x320 (uint8 frames in memory),
     batch 4 windows.  Checks the output frames, the splat kernels'
     launches per forward batch (K7 once for VESPCN, MCResNet and LTDVSR,
     K8 once for DRVSR, nothing else), and, on the first window, the
     bf16 and float32 kernel paths against the float32 plain path, on the
     whole SR and on the trunk's part of it (SR less the bicubic upscale
     of the centre frame, which the splat never touches); prints
     delivered HR frames/s beside the forward's alone, and peak memory.

  7. DUF-52L (7 frames, x4, 21 SAME-T + 3 VALID-T dense blocks, growth
     16, bf16, seeded random weights and BatchNorm statistics):
     a. kernels 9 (a dense block) and 10 (its growth conv) against their
        plain versions at batch 2, LR 180x320, at the first block (F 64),
        the last SAME-T block (F 384), the last VALID-T block (F 432, T
        3 -> 1) and a 16L block (F 128, G 32), in float32 and bfloat16;
        kernels 9 and 10 bitwise equal over two launches;
        kernel 9 on a buffer and scratch that hold NaN wherever the block
        may not read: the new channels are finite and every other element
        is bitwise unchanged; times and TFLOP/s beside the plain versions',
        F.conv3d's (kernel 10, with the ratio) and the bound;
     b. serving end to end: Predictor.test_video_lr over the clip degraded
        on the device to 180x320 (uint8 blur4/ frames in memory), batch 4
        windows; checks the 24 output frames, kernel 9's 24 launches per
        forward batch and no other kernel, and on the first window the
        bf16 and float32 kernel paths against the float32 plain path on
        the SR and on the backbone's output (the dynamic-filtered centre
        frame, most of |SR|, never passes the backbone); delivered HR
        frames/s beside the forward's alone, and peak memory;
     c. the same window with conv3d_impl="pallas": kernel 10 launched 24
        times, kernel 9 none, against the float32 plain path.
  8. FRVSR streaming serving at full width (mf 128, 10 residual blocks,
     bf16, seeded random weights): Predictor.test_video_lr over the clip
     degraded to 180x320, frame by frame with the state on the card.
     Checks the 24 output frames, kernel 7's 23 launches (once a frame
     after the first, at the HR grid) and no other kernel, and at every
     frame, teacher-forced, the bf16 and float32 kernel paths' step
     against the float32 plain path's; prints the free-running drift, the
     forward alone ms a frame (CUDA events around back-to-back steps),
     delivered HR frames/s (and again for a second video), the device's
     busy share (torch.profiler), the host's time to enqueue a step beside
     the device's and its costliest operators, and peak memory.
  9. flow-family training at each paper config of config.py (VESPCN, MCResNet,
     LTDVSR, DRVSR, FRVSR at full width, float32, seeded weights) on four
     seeded 12-frame 448x448 clips in memory (truth/ and blur4/ degraded on
     the card) through TrainPipeline:
     a. one fixed batch: the joint loss and every parameter's gradient
        through K7/K8 (forward, `BoundedSplat` / `SpmcSplat`) and their
        gather adjoints (backward) against pure autograd on the plain path,
        worst relative L2 per parameter within GRAD_TOL; the launches a
        step (FLOW_FAMILIES) and the adjoints' ms in the backward (CUDA
        events around each adjoint call);
     b. Trainer.fit on the kernel and the plain path, the four staged
        families switching two steps into the timed window: launches a step,
        finite losses, steady steps/s, peak memory, and on the kernel path
        the device's busy ms a step (torch.profiler);
 10. the Evaluator on the card for all seven families (full width, float32,
     seeded weights), one batch of 4 windows at eval_in_size 128x240 over
     four seeded 20-frame sequences in memory: finite PSNR, the kernels'
     launches a batch (EVAL_LAUNCHES), and for the Y families one frame's
     SSIM on the card (`compute_ssim_batch`) within SSIM_TOL of the float64
     host SSIM.
 11. DUF-52L training at the duf preset of config.py (batch 11, 7 frames,
     LR 32 / GT 128, the "double" producer, float32, seeded weights) on four
     seeded 12-frame 448x448 clips in memory through TrainPipeline:
     a. kernel 10's float32 entry at the training shape against F.conv3d
        (ms, bound, error) at four growth convs; then
        one fixed batch in training mode: conv3d_impl="pallas" (kernel 10
        forward under autograd, `Conv3x3x3`, once per growth conv) against
        pure autograd on the plain path: the Huber loss, every gradient
        within GRAD_TOL or NOISE_FACTOR times what float32 alone moves it
        (the batch order reversed on either path, PyTorch's native conv in
        place of cuDNN's on the plain path), whichever is larger (the
        biases a training BatchNorm cancels, 0 in exact arithmetic, over
        the median gradient norm), and the five BatchNorm buffers after the
        step within BN_BUFFER_TOL;
     b. Trainer.fit on the default path (conv3d_impl auto: cuDNN, no
        kernel in training) and on "pallas" (kernel 10): launches a step,
        finite losses, steady steps/s, peak memory, the device's busy share;
     c. the default path's trained model through the Evaluator in eval mode
        (kernel 9 24 times a batch, on the moving statistics training made,
        the model given back in training mode), then one window's backbone
        output on the float32 and bf16 kernel paths against the float32
        plain path (BACKBONE_TOL).
 12. EasyFlow and FlowNet: a. EasyFlowTrainer at the reference's config
     (batch 20, crop 100, 7 frames) on seeded in-memory clips, summaries
     off: steps/s with its host sampling, the busy share; b. its last
     checkpoint into a VESPCN (`restore_easyflow_params`) whose Trainer.fit
     takes 3 steps (kernel 7 once a step; the pre-trained flow held through
     the SR-only stage); c. FlowNetS, FlowNetC and WarpConfidence (eval
     mode) forward at FlowNet's published 384x512, batch 8: ms, peak
     memory, and the first pair against the same weights on the CPU.
 13. AOT export (infer/export.py; every launch a torch.ops.pfnl custom op):
     a. PFNL at phase 4's configuration, b. VESPCN (phase 6's) and DUF-52L
     (phase 7b's): export_model(model_name=...) at one batch of 4 windows
     at 180x320, load_exported, one call: the seconds of export and load,
     the artifact's MB, its pfnl nodes and launches a call (PFNL K1 1, K2
     20, K3 20, K4 1; VESPCN K7 1; DUF-52L K9 24; none while tracing), its
     output against eager serve (uint8 within 1 step, relative L2 1e-3),
     forward ms of artifact and eager serve, and the refusal of a CPU input
     and of another shape.
 14. multi-GPU on the one GPU: a. Predictor(devices=[cuda:0]) through
     sharded_apply_dp at phase 4's configuration, its frames and launches
     bitwise the single-device Predictor's; b. nonlocal_attention_sp over a
     world-1 NCCL group at [4,14400,84] bf16, bitwise nonlocal_flash's, one
     K1 launch; c. Trainer.fit under DDP over that group at phase 5c's
     config: one step from the same weights and batch within 1e-6 of the
     plain Trainer's, steps/s beside the plain Trainer's and phase 5c's,
     peak memory; d. two processes on cuda:0 over gloo, one DDP step at the
     paper config with the global batch of 16 (8 a rank, kernels 2-6), the
     parameters within 5e-5 of one process's step at batch 16.

The second-to-last line is a JSON summary of the kernels: launches from
the path that runs each (phase 4 plus 5c for kernels 1-6, 6 and 8 for
7, 6 for 8, 7b for 9, 7c for 10; and phase 9b's kernel path for 7 and 8,
phase 10 for 1-4 and 7-9, 11b's kernel-10 path for 10, 11c for 9, 12b
for 7, 13 for 1-4, 7 and 9, 14a-c for 1-6; each counted where the
custom op's CUDA kernel launches); errors and times at the shape named in
TIMED (bf16 but for kernels 5 and 6, float32 at the training shape);
`bound_ms`, the least time the card could take for the same work (the larger of the
bytes each call must move over 3.35 TB/s and its operations over the
peak rate of their type, 989 TFLOP/s bf16 or 67 float32, NVIDIA's data
sheet; kernels 5 and 6 in float32: three times their operations over 495
TFLOP/s TF32), with what sets it; `library_ms`, one PyTorch call computing
the same function where there is one (kernel 1:
scaled_dot_product_attention with scale 1; kernel 10: F.conv3d; kernels
5 and 6: cuDNN's conv backward as in phase 5a, two calls for kernel 5),
else null.  The last line is
{"ok": true, "device": {...}}.  There is no CPU fallback: without a CUDA
device the script fails before printing any result.
"""

import contextlib
import json
import math
import re
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
B, T, H, W, C = 2, 7, 180, 320, 64      # phase 3 shapes: the main path's
CLIP_FRAMES, BATCH_WINDOWS = 24, 4      # phases 4, 6, 7b: six forward batches of 4 windows
TOL = {"float32": 1e-4, "bfloat16": 2e-2}  # max |kernel - plain| / max |plain|
E2E_TOL = 2e-2                          # ||SR_bf16,kernels - SR_f32,plain|| / ||SR_f32,plain||
TRAIN_B, TRAIN_HW = 16, 32              # phase 5: the paper's batch and LR crop, 7 frames
BWD_SHAPES = [(TRAIN_B, T, TRAIN_HW, TRAIN_HW), (B, T, H, W)]
GRAD_TOL = 1e-3                         # ||g_kernels - g_plain|| / ||g_plain|| per parameter
FIT_WARM, FIT_STEPS = 3, 22             # phase 5c: steps before / inside the timed window
# phase 6: family -> (the splat kernel its serving forward launches, whether its SR
# adds bicubic(centre Y), which the splat never touches and which is most of |SR|)
Y_FAMILIES = {"vespcn": ("bounded_splat", True), "drvsr": ("spmc_splat", True),
              "mcresnet": ("bounded_splat", True), "ltdvsr": ("bounded_splat", False)}
# phase 6, the trunk's part of SR (SR less that bicubic), relative L2 against the f32 plain
# path: bf16 kernels, where bf16 rounding alone gave 3e-2 on the CPU at 48x64 and a wrong
# splat gives O(1); f32 kernels, where only summation order differs
TRUNK_TOL = {"bfloat16": 1e-1, "float32": 1e-4}
PFNL_KERNELS = ("nonlocal_flash", "pfrb_a", "pfrb_b", "pfnl_tail", "pfrb_bwd_b", "pfrb_bwd_a")
HBM_PEAK_GBS = 3350.0                   # H100 SXM HBM3, NVIDIA's data sheet
# dense bf16 and TF32 tensor cores; float32 CUDA cores.  A 3xTF32 kernel (the float32 entries
# of kernels 5 and 6) runs three TF32 products for each float32 one
PEAK_TFLOPS = {"bfloat16": 989.0, "tf32": 495.0, "float32": 67.0}
# phase 7a: (label, F, G, mode, input planes [lo, hi) of a 7-plane buffer)
DUF_CASES = [("first block", 64, 16, "thw", 0, 7), ("last SAME-T block", 384, 16, "thw", 0, 7),
             ("last VALID-T block", 432, 16, "hw", 2, 5), ("16L block", 128, 32, "thw", 0, 7)]
DUF_TIMED = "last SAME-T block"         # the 7a case in the JSON summary
# phase 7b: rel L2 of the backbone's output against the f32 plain path; bf16: 24 blocks
# each rounding `a` and its output to bf16 (2^-8 relative) compound; f32: summation order
BACKBONE_TOL = {"bfloat16": 1e-1, "float32": 1e-4}
TIMED = {"nonlocal_flash": "bf16 [2,14400,84]", "pfrb_a": "bf16 [2,7,180,320,64]",
         "pfrb_b": "bf16 [2,7,180,320,64]", "pfnl_tail": "bf16 [2,7,180,320,64]",
         "pfrb_bwd_b": "float32 [16,7,32,32,64]", "pfrb_bwd_a": "float32 [16,7,32,32,64]",
         "bounded_splat": "bf16 VESPCN [12,1,180,320] R=2", "spmc_splat": "bf16 DRVSR [12,180,320]",
         "duf_block": "bf16 F=384 [2,7,180,320]", "duf_dense": "bf16 F=384 [2,7,180,320]"}
TPU_KERNEL = {
    "nonlocal_flash": "pfnl_tpu/ops/pallas/nonlocal_flash.py:103",
    "pfrb_a": "pfnl_tpu/ops/pallas/pfrb_pack.py:313",
    "pfrb_b": "pfnl_tpu/ops/pallas/pfrb_pack.py:330",
    "pfnl_tail": "pfnl_tpu/ops/pallas/pfnl_tail.py:187",
    "pfrb_bwd_b": "pfnl_tpu/ops/pallas/pfrb_bwd.py:194",
    "pfrb_bwd_a": "pfnl_tpu/ops/pallas/pfrb_bwd.py:224",
    "bounded_splat": "pfnl_tpu/ops/pallas/bounded_splat.py:83",
    "spmc_splat": "pfnl_tpu/ops/pallas/spmc_splat.py:95",
    "duf_block": "pfnl_tpu/ops/pallas/duf_block.py:218",
    "duf_dense": "pfnl_tpu/ops/pallas/duf_dense.py:109",
}
SOURCE = {
    "nonlocal_flash": "pfnl_tpu_torch/csrc/nonlocal_flash.cu",
    "pfrb_a": "pfnl_tpu_torch/csrc/pfrb.cu",
    "pfrb_b": "pfnl_tpu_torch/csrc/pfrb.cu",
    "pfnl_tail": "pfnl_tpu_torch/csrc/pfnl_tail.cu",
    "pfrb_bwd_b": "pfnl_tpu_torch/csrc/pfrb_bwd.cu",
    "pfrb_bwd_a": "pfnl_tpu_torch/csrc/pfrb_bwd.cu",
    "bounded_splat": "pfnl_tpu_torch/csrc/bounded_splat.cu",
    "spmc_splat": "pfnl_tpu_torch/csrc/spmc_splat.cu",
    "duf_block": "pfnl_tpu_torch/csrc/duf_block.cu",
    "duf_dense": "pfnl_tpu_torch/csrc/duf_dense.cu",
}
# phase 9: the flow families' launches a training step (forward) and the adjoint calls in
# its backward: K7 once (DRVSR K8 once, and K7 for the full form's `warped_lr`, which no
# loss reads, so no adjoint; JAX's jit drops that splat as dead code); FRVSR at T=10 K7
# twice a frame after the first (the HR-grid upscale warp and the LR `warps`)
FLOW_FAMILIES = {"vespcn": ({"bounded_splat": 1}, 1), "mcresnet": ({"bounded_splat": 1}, 1),
                 "ltdvsr": ({"bounded_splat": 1}, 1),
                 "drvsr": ({"spmc_splat": 1, "bounded_splat": 1}, 1),
                 "frvsr": ({"bounded_splat": 18}, 18)}
FLOW_WARM, FLOW_STEPS = 3, 8            # phase 9b: steps before / inside the timed window
FLOW_CLIP = (4, 12, 448)                # phase 9: clips, frames, HR side (DRVSR crops 400)
# phase 10: the Evaluator's launches a batch of 4 windows, eval_in_size 128x240, float32
EVAL_LAUNCHES = {"pfnl": {"nonlocal_flash": 1, "pfrb_a": 20, "pfrb_b": 20, "pfnl_tail": 1},
                 "vespcn": {"bounded_splat": 1}, "mcresnet": {"bounded_splat": 1},
                 "ltdvsr": {"bounded_splat": 1}, "drvsr": {"spmc_splat": 1, "bounded_splat": 1},
                 "frvsr": {"bounded_splat": 18}, "duf": {"duf_block": 24}}
SSIM_TOL = 1e-4                         # phase 10: card SSIM of a frame vs float64 on the host
DUF_WARM, DUF_STEPS = 3, 8              # phase 11b: steps before / inside the timed window
BN_BUFFER_TOL = 1e-5                    # phase 11a: max|k - p| / max|p| of each BatchNorm buffer
# phase 11a: DUF's training gradients against plain autograd on GRAD_BATCHES batches, in
# units of the most that float32 alone moves them on the plain path
NOISE_FACTOR, GRAD_BATCHES = 3, 3
EF_BATCH, EF_CROP, EF_FRAMES = 20, 100, 7   # phase 12a: the reference's EasyFlow config
EF_WARM, EF_STEPS = 3, 8                # phase 12a: steps before / inside the timed run
FLOWNET_BATCH, FLOWNET_HW = 8, (384, 512)   # phase 12c: FlowNet's published input size
# phase 13: an artifact's frames against eager serve's (the same kernels in the same order):
# uint8 steps, and relative L2 of the float output
EXPORT_U8_STEPS, EXPORT_REL_TOL = 1, 1e-3
# phase 13: the pfnl nodes of each artifact, and so its launches a call
EXPORT_WANT = {"pfnl": {"nonlocal_flash": 1, "pfrb_a": 20, "pfrb_b": 20, "pfnl_tail": 1},
               "vespcn": {"bounded_splat": 1}, "duf": {"duf_block": 24}}
DDP1_TOL = 1e-6     # 14c: max |p_DDP - p| after one step, world size 1, against the plain Trainer
DDP2_TOL = 5e-5     # 14d: two ranks against one process at batch 16 (tests/test_parallel.py:70)
# phase 2: the kernel entries that must run on the tensor cores (a substring of the
# mangled entry name: the bf16 entries of kernels 1, 2, 3, 4, 9 and 10, every instantiation)
TF32_ENTRIES = ("pfrb_bwd_b_tf32_mma_kernel", "pfrb_bwd_a_tf32_mma_kernel",
                "wgrad_tf32_mma_kernel")  # the float32 entries of kernels 5 and 6: 3xTF32
TENSOR_CORE_ENTRIES = ("nonlocal_flash_bf16_mma_kernel", "pfrb_a_bf16_mma_kernel",
                       "pfrb_b_bf16_mma_kernel", "pfnl_tail_bf16_mma_kernel",
                       "duf_block_pointwise_bf16_mma_kernel", "duf_block_conv_bf16_mma_kernel",
                       "duf_dense_bf16_mma_kernel") + TF32_ENTRIES
# phase 2: the entries of kernels 7 and 8, whose shared-memory tiles must not spill
SPLAT_ENTRIES = ("bounded_splat_kernel", "spmc_splat_kernel")
# phases 3 and 7a: equal over two launches (7a holds kernel 10 so as well)
BITWISE_KERNELS = ("nonlocal_flash", "pfrb_a", "pfrb_b", "pfnl_tail", "duf_block")


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


def nbytes(*tensors):
    """Bytes of the tensors, each counted once (tuples flattened)."""
    flat = [t for x in tensors for t in (x if isinstance(x, (tuple, list)) else (x,))]
    return sum(t.numel() * t.element_size() for t in flat if isinstance(t, torch.Tensor))


def bound(flop, nbyte, dtype_key):
    """(ms, what sets it): the larger of the bytes over the HBM rate and the
    operations over the peak rate of their type."""
    t_bytes = nbyte / (HBM_PEAK_GBS * 1e9)
    t_ops = flop / (PEAK_TFLOPS[dtype_key] * 1e12)
    return max(t_bytes, t_ops) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


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
    counts = hmma_counts(_build.LIB, _build.tool)
    names = _demangled(list(counts), _build.tool)
    print(f"[2 sass] HMMA instructions per kernel entry (cuobjdump -sass {_build.LIB}):")
    for mangled, n in counts.items():
        print(f"  {n:5d}  {names[mangled]}")
    for want in TENSOR_CORE_ENTRIES:
        found = {k: n for k, n in counts.items() if want in k}
        if not found or not all(found.values()):
            fail(f"{want}: entries {found or 'missing'}; every one must hold HMMA instructions")
    spills = ptxas_spills(_build.PTXAS_LOG)
    spilled = {k: v for k, v in spills.items() if any(e in k for e in TF32_ENTRIES) and any(v)}
    if spilled or not any(e in k for k in spills for e in TF32_ENTRIES):
        fail(f"the 3xTF32 entries must build without spills: {spilled or 'missing'}")
    for want in SPLAT_ENTRIES:
        found = {k: v for k, v in spills.items() if want in k}
        if not found or any(any(v) for v in found.values()):
            fail(f"{want}: entries {found or 'missing'} must build without spills")


def ptxas_spills(log):
    """{mangled kernel entry: (spill store bytes, spill load bytes)} from the
    ptxas report."""
    spills, entry = {}, None
    with open(log) as f:
        for line in f:
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                entry = m.group(1)
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m and entry is not None:
                spills[entry] = (int(m.group(1)), int(m.group(2)))
    return spills


def hmma_counts(lib, tool):
    """{mangled kernel entry: HMMA instructions in its SASS}, from cuobjdump -sass."""
    sass = subprocess.run([tool("cuobjdump"), "-sass", lib], capture_output=True, text=True,
                          check=True, timeout=300).stdout
    counts, entry = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            entry = m.group(1)
            counts[entry] = 0
        elif entry is not None and "HMMA" in line:
            counts[entry] += 1
    return counts


def _demangled(names, tool):
    """{mangled: readable name without its parameter list}, by cu++filt where
    the toolkit has it, else the mangled names."""
    try:
        out = subprocess.run([tool("cu++filt")], input="\n".join(names), capture_output=True,
                             text=True, check=True, timeout=60).stdout.splitlines()
    except (RuntimeError, OSError, subprocess.SubprocessError):
        return {n: n for n in names}
    if len(out) != len(names):
        return {n: n for n in names}
    # drop the namespace and the casts of template arguments ("(int)16"), then the parameters
    short = (re.sub(r"\(anonymous namespace\)::|<unnamed>::|\((?:int|bool)\)", "", o).split("(")[0]
             for o in out)
    return dict(zip(names, short))


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


def _bitwise_equal(got, again):
    got = got if isinstance(got, tuple) else (got,)
    again = again if isinstance(again, tuple) else (again,)
    return all(torch.equal(a, b) for a, b in zip(got, again))


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
            # kernels 1-4 also bitwise equal over two launches
            same = _bitwise_equal(got, kernel(*args)) if name in BITWISE_KERNELS else None
            torch.cuda.synchronize()
            abs_err, rel_err = _max_errs(got, ref)
            ok = rel_err <= TOL[key]
            note = "" if same is None else f"; bitwise equal over two launches: {same}"
            print(f"[3 kernel] {name} {key}: max_abs_err {abs_err:.3e}, max_rel_err "
                  f"{rel_err:.3e} (tolerance {TOL[key]:.0e} of max|plain|) "
                  f"{'ok' if ok else 'DISAGREES'}{note}", flush=True)
            if not ok:
                fail(f"{name} {key} disagrees with its plain version")
            if same is False:
                fail(f"{name} {key}: two launches differ")
            res[key] = abs_err
        args = make(torch.bfloat16)
        for fn in (kernel, plain):  # warm-up
            fn(*args)
        p1 = cuda_time_ms(lambda: plain(*args))
        k1 = cuda_time_ms(lambda: kernel(*args))
        k2 = cuda_time_ms(lambda: kernel(*args))
        p2 = cuda_time_ms(lambda: plain(*args))
        ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
        bound_ms, bound_by = bound(flop, nbytes(args, kernel(*args)), "bfloat16")
        library_ms, lib_note = None, ""
        if name == "nonlocal_flash":  # softmax(theta phi^T) g, unscaled
            lib = lambda: torch.nn.functional.scaled_dot_product_attention(*args, scale=1.0)
            lib_err = _max_errs(lib(), plain(*args))[1]
            library_ms = cuda_time_ms(lib)
            lib_note = (f", scaled_dot_product_attention(scale=1) {library_ms:.3f} ms (max_rel_err "
                        f"{lib_err:.3e} vs plain; kernel / library {ms / library_ms:.3f})")
        print(f"[3 time] {name} bf16 [{B},{T},{H},{W}]: kernel {ms:.3f} ms "
              f"({flop / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.3f} ms "
              f"({flop / plain_ms / 1e9:.2f} TFLOP/s){lib_note}; bound {bound_ms:.3f} ms "
              f"({bound_by}) on {card}", flush=True)
        results[name] = dict(max_abs_err=res["bfloat16"], max_abs_err_f32=res["float32"],
                             ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                             library_ms=library_ms)
    return results


def phase_splat_kernels(card):
    """3 (splats): kernels 7 and 8 against their plain versions at their
    callers' shapes, bitwise equal over two launches, and their bf16
    times beside the plain versions' with the bytes they move."""
    from pfnl_tpu_torch.ops.cuda.bounded_splat import bounded_splat
    from pfnl_tpu_torch.ops.cuda.profile_splats import SPLAT_CASES, device_time_ms
    from pfnl_tpu_torch.ops.cuda.spmc_splat import spmc_splat
    from pfnl_tpu_torch.ops.warp import forward_warp_local_ref, forward_warp_local_spmc

    fns = {"bounded_splat": (lambda im, uv, r: bounded_splat(im, uv, r),
                             lambda im, uv, r: forward_warp_local_ref(im, uv, r)),
           "spmc_splat": (lambda im, uv, r: spmc_splat(im, uv, 4, r),
                          lambda im, uv, r: forward_warp_local_spmc(im, uv, 4, r))}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    results = {}
    for name, caller, (b, c, h, w), r in SPLAT_CASES:
        kernel, plain = fns[name]
        im32 = torch.rand((b, h, w, c), generator=gen, device="cuda")
        uv32 = (torch.rand((b, h, w, 2), generator=gen, device="cuda") * 2 - 1) * r
        res = {}
        for dt in (torch.float32, torch.bfloat16):
            key = str(dt).replace("torch.", "")
            im, uv = im32.to(dt), uv32.to(dt)
            got, again, ref = kernel(im, uv, r), kernel(im, uv, r), plain(im, uv, r)
            torch.cuda.synchronize()
            abs_err, rel_err = _max_errs(got, ref)
            same = torch.equal(got, again)
            ok = rel_err <= TOL[key]
            print(f"[3 kernel] {name} ({caller}) {key} [{b},{c},{h},{w}] R={r}: max_abs_err "
                  f"{abs_err:.3e}, max_rel_err {rel_err:.3e} (tolerance {TOL[key]:.0e} of "
                  f"max|plain|) {'ok' if ok else 'DISAGREES'}; bitwise equal over two "
                  f"launches: {same}", flush=True)
            if not ok:
                fail(f"{name} {key} {(b, c, h, w)} disagrees with its plain version")
            if not same:
                fail(f"{name} {key} {(b, c, h, w)}: two launches differ")
            res[key] = abs_err
        im, uv = im32.bfloat16(), uv32.bfloat16()
        nbyte = 2 * (im.numel() + uv.numel() + got.numel())   # read once, write once, bf16
        for fn in (kernel, plain):  # warm-up
            fn(im, uv, r)
        p1 = cuda_time_ms(lambda: plain(im, uv, r))
        k1 = cuda_time_ms(lambda: kernel(im, uv, r))
        k2 = cuda_time_ms(lambda: kernel(im, uv, r))
        p2 = cuda_time_ms(lambda: plain(im, uv, r))
        d1, d2 = (device_time_ms(lambda: kernel(im, uv, r)) for _ in range(2))
        ms, plain_ms, dev_ms = (k1 + k2) / 2, (p1 + p2) / 2, (d1 + d2) / 2
        gbs = nbyte / ms / 1e6
        # a multiply-add per bilinear tap and channel of every source pixel
        bound_ms, bound_by = bound(2.0 * 4 * b * h * w * c, nbyte, "float32")
        print(f"[3 time] {name} ({caller}) bf16 [{b},{c},{h},{w}] R={r}: kernel {ms:.4f} ms "
              f"({k1:.4f}, {k2:.4f}; {nbyte / 1e6:.1f} MB, {gbs:.1f} GB/s, "
              f"{gbs / HBM_PEAK_GBS:.1%} of {HBM_PEAK_GBS:.0f} GB/s), plain {plain_ms:.3f} ms "
              f"({p1:.3f}, {p2:.3f}; {nbyte / plain_ms / 1e6:.1f} GB/s); bound {bound_ms:.4f} ms "
              f"({bound_by}), kernel {ms / bound_ms:.1f}x the bound; the kernel's device time "
              f"alone {dev_ms:.4f} ms ({d1:.4f}, {d2:.4f}; {nbyte / dev_ms / 1e6:.1f} GB/s, "
              f"{dev_ms / bound_ms:.1f}x the bound), on {card}", flush=True)
        if name not in results:  # the first case of each kernel is the summary's
            results[name] = dict(max_abs_err=res["bfloat16"], max_abs_err_f32=res["float32"],
                                 ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                 library_ms=None)
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


def forward_alone(tag, model, lrs, fps, card):
    """The serving program alone on the clip's first batch of windows (CUDA
    events around `serve`, the mean of two timings of 3 calls), printed
    beside the Predictor's delivered rate `fps`."""
    from pfnl_tpu_torch.infer.predictor import _clipped_windows, serve

    batch = torch.from_numpy(lrs[_clipped_windows(CLIP_FRAMES, model.num_frames)[:BATCH_WINDOWS]])
    batch = batch.cuda()
    with torch.inference_mode():
        serve(model, batch)
        fwd_ms = (cuda_time_ms(lambda: serve(model, batch)) +
                  cuda_time_ms(lambda: serve(model, batch))) / 2
    fwd_fps = BATCH_WINDOWS / fwd_ms * 1e3
    print(f"[{tag}] forward alone {fwd_ms:.3f} ms a batch of {BATCH_WINDOWS} ({fwd_fps:.2f} HR "
          f"frames/s) beside delivered {fps:.2f} HR frames/s ({fps / fwd_fps:.1%} of the "
          f"forward's rate) on {card}", flush=True)


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

    want = {k: 0 for k in KERNELS}
    want.update(nonlocal_flash=1, pfrb_a=model.num_blocks, pfrb_b=model.num_blocks, pfnl_tail=1)
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

    lrs = pred._degrade_video(clip.astype(np.float32) / 255.0)
    forward_alone("4 e2e", model, lrs, fps, card)

    # the first window: bf16 kernels vs the float32 plain path, TF32 off
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


def bwd_inputs(shape, dt, gen):
    """Kernel 5 and 6 inputs at [n,t,h,w,64]: the saved activations of a
    block with non-zero biases (through the plain forward) and cotangents."""
    from pfnl_tpu_torch.ops.pfrb_ref import pfrb_a_ref

    n, t, h, w = shape
    feat = _rand((n, t, h, w, C), gen, 0.5).to(dt)
    w1 = _glorot((3, 3, C, C), 9 * C, 9 * C, gen)
    wfuse = _glorot((t, C, C), t * C, C, gen)
    w2f, w2b = (_glorot((3, 3, C, C), 18 * C, 9 * C, gen) for _ in range(2))
    b1, bfuse = _rand((C,), gen, 0.1), _rand((C,), gen, 0.1)
    i1, base = pfrb_a_ref(feat, w1, b1, wfuse, bfuse)
    dz, g = (_rand((n, t, h, w, C), gen, 0.05).to(dt) for _ in range(2))
    return {"pfrb_bwd_b": (dz, i1, base, w2f, w2b), "pfrb_bwd_a": (dz, feat, g, w1)}


def _conv_backward(dy, x, w):
    """aten.convolution_backward of the SAME 3x3 conv x [B,H,W,Ci] -> dy
    [B,H,W,Co] with the HWIO kernel w, channels-last views, all three
    gradients; returns (dx [B,H,W,Ci], dW HWIO, db)."""
    dx, dw, db = torch.ops.aten.convolution_backward(
        dy.permute(0, 3, 1, 2), x.permute(0, 3, 1, 2), w, [w.shape[0]], [1, 1], [1, 1],
        [1, 1], False, [0, 0], 1, [True, True, True])
    return dx.permute(0, 2, 3, 1), dw.permute(2, 3, 1, 0), db


def bwd_library(name, args):
    """The PyTorch yardstick of kernel 5 or 6, float32: cuDNN's conv
    backward (aten.convolution_backward, the port never calls it) for the
    same convs.  K6: one call plus the add of g.  K5, a composite of two
    calls: the frames (d_i1, dW2f, db2) and the base (d_base, dW2b) from
    the frame sum.  Returns a function giving the kernel's outputs."""
    n, t, h, w, c = args[0].shape
    oihw = lambda k: k.permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    if name == "pfrb_bwd_a":
        dz1, feat, g, w1 = args
        dz4, x4, k = dz1.reshape(n * t, h, w, c), feat.reshape(n * t, h, w, c), oihw(w1)

        def run():
            dx, dw, db = _conv_backward(dz4, x4, k)
            return g + dx.reshape(n, t, h, w, c), dw, db
        return run
    dz2, i1, base, w2f, w2b = args
    dz4, x4, kf, kb = dz2.reshape(n * t, h, w, c), i1.reshape(n * t, h, w, c), oihw(w2f), oihw(w2b)

    def run():
        d_i1, dw2f, db2 = _conv_backward(dz4, x4, kf)
        d_base, dw2b, _ = _conv_backward(dz2.sum(1), base, kb)
        return d_i1.reshape(n, t, h, w, c), d_base, dw2f, dw2b, db2
    return run


def phase_bwd_kernels(card):
    """5a: kernels 5 and 6 against their plain versions, bitwise weight
    gradients over two launches, and their times beside the plain ones,
    cuDNN's conv backward (float32) and the bounds."""
    from pfnl_tpu_torch.ops.cuda.pfrb_bwd import pfrb_bwd_a, pfrb_bwd_b
    from pfnl_tpu_torch.ops.pfrb_ref import pfrb_bwd_a_ref, pfrb_bwd_b_ref

    fns = {"pfrb_bwd_b": (pfrb_bwd_b, pfrb_bwd_b_ref, 2), "pfrb_bwd_a": (pfrb_bwd_a,
                                                                        pfrb_bwd_a_ref, 1)}
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    results = {}
    for shape in BWD_SHAPES:
        n, t, h, w = shape
        # per PFRB backward: 3 frame convs + 1 base conv (data and weight), as 3x3x64x64 MACs
        flop = {"pfrb_bwd_b": 2.0 * 9 * C * C * (2 * n * t + 2 * n) * h * w,
                "pfrb_bwd_a": 2.0 * 9 * C * C * 2 * n * t * h * w}
        for dt in (torch.float32, torch.bfloat16):
            key = str(dt).replace("torch.", "")
            inputs = bwd_inputs(shape, dt, gen)
            for name, (kernel, plain, n_data) in fns.items():
                args = inputs[name]
                got, again, ref = kernel(*args), kernel(*args), plain(*args)
                torch.cuda.synchronize()
                errs = [_max_errs(a, b) for a, b in zip(got, ref)]
                abs_err, rel_err = max(e[0] for e in errs), max(e[1] for e in errs)
                same = all(torch.equal(a, b) for a, b in zip(got[n_data:], again[n_data:]))
                ok = rel_err <= TOL[key]
                print(f"[5a kernel] {name} {key} {list(shape)}: max_abs_err {abs_err:.3e}, "
                      f"max_rel_err {rel_err:.3e} (tolerance {TOL[key]:.0e} of max|plain| per "
                      f"output) {'ok' if ok else 'DISAGREES'}; weight grads bitwise equal over "
                      f"two launches: {same}", flush=True)
                if not ok:
                    fail(f"{name} {key} {shape} disagrees with its plain version")
                if not same:
                    fail(f"{name} {key} {shape}: weight gradients differ between two launches")
                p1 = cuda_time_ms(lambda: plain(*args))
                k1 = cuda_time_ms(lambda: kernel(*args))
                k2 = cuda_time_ms(lambda: kernel(*args))
                p2 = cuda_time_ms(lambda: plain(*args))
                ms, plain_ms = (k1 + k2) / 2, (p1 + p2) / 2
                f, nbyte = flop[name], nbytes(args, got)
                library_ms, lib_note = None, ""
                if dt == torch.float32:
                    # float32 runs 3xTF32 on the tensor cores: three TF32 products a float32 one
                    bound_ms, bound_by = bound(3 * f, nbyte, "tf32")
                    cores_ms = bound(f, nbyte, "float32")[0]
                    bound_note = (f"bound {bound_ms:.3f} ms 3xTF32 ({bound_by}), {cores_ms:.3f} "
                                  f"ms float32 CUDA cores; {3 * f / ms / 1e9:.2f} TFLOP/s of "
                                  f"TF32 issue")
                    lib = bwd_library(name, args)
                    lib_err = max(_max_errs(a, b)[1] for a, b in zip(lib(), ref))
                    library_ms = (cuda_time_ms(lib) + cuda_time_ms(lib)) / 2
                    calls = "a composite of two calls and the frame sum" if name == "pfrb_bwd_b" \
                        else "one call and the add of g"
                    lib_note = (f", cuDNN convolution_backward ({calls}) {library_ms:.3f} ms "
                                f"(max_rel_err {lib_err:.3e} vs plain, a note; kernel / library "
                                f"{ms / library_ms:.3f})")
                else:
                    bound_ms, bound_by = bound(f, nbyte, key)
                    bound_note = f"bound {bound_ms:.3f} ms ({bound_by})"
                print(f"[5a time] {name} {key} {list(shape)}: kernel {ms:.3f} ms "
                      f"({f / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.3f} ms "
                      f"({f / plain_ms / 1e9:.2f} TFLOP/s){lib_note}; {bound_note} on {card}",
                      flush=True)
                if shape == BWD_SHAPES[0] and dt == torch.float32:
                    results[name] = dict(max_abs_err=abs_err, ms=ms, plain_ms=plain_ms,
                                         bound_ms=bound_ms, bound_by=bound_by,
                                         library_ms=library_ms)
    return results


def paper_model(gen_seed):
    """Full-width PFNL (mf 64, 20 PFRBs, 7 frames, x4), float32, seeded
    weights with non-zero biases, on the card."""
    from pfnl_tpu_torch.models.pfnl import PFNL

    model = PFNL(generator=torch.Generator().manual_seed(gen_seed))
    gen = torch.Generator().manual_seed(gen_seed + 1)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(torch.randn(p.shape, generator=gen) * 0.02)
    return model.cuda()


def phase_train_gradients(card):
    """5b: one fixed batch; every gradient through kernels 2-6 against pure
    autograd on the plain path."""
    from pfnl_tpu_torch.ops.cuda import KERNELS, launches, reset_launches
    from pfnl_tpu_torch.train.losses import pfnl_loss

    model = paper_model(SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    x = torch.rand((TRAIN_B, T, TRAIN_HW, TRAIN_HW, 3), generator=gen, device="cuda")
    gt = torch.rand((TRAIN_B, 1, 4 * TRAIN_HW, 4 * TRAIN_HW, 3), generator=gen, device="cuda")
    res = {}
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        reset_launches()
        loss = pfnl_loss({"sr": model(x, plain=plain)}, gt, x)["loss"]
        loss.backward()
        torch.cuda.synchronize()
        res[plain] = (loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()},
                      {k: launches[k] for k in KERNELS})
    print(f"[5b grads] launches, kernel path: {res[False][2]}; plain path: {res[True][2]}",
          flush=True)
    if (sum(res[True][2].values()) or not all(res[False][2][k] for k in PFNL_KERNELS[1:])
            or any(res[False][2][k] for k in KERNELS if k not in PFNL_KERNELS)):
        fail("the kernel path must launch kernels 2-6 and the plain path none")
    rel = {k: ((res[False][1][k] - g).norm() / g.norm()).item() for k, g in res[True][1].items()}
    worst = max(rel, key=rel.get)
    loss_k, loss_p = res[False][0], res[True][0]
    print(f"[5b grads] batch {TRAIN_B}, LR {TRAIN_HW}x{TRAIN_HW}, float32: loss kernels "
          f"{loss_k:.7f}, plain {loss_p:.7f}; worst ||g_k - g_p|| / ||g_p|| over "
          f"{len(rel)} parameters {rel[worst]:.3e} ({worst}; tolerance {GRAD_TOL:.0e}), median "
          f"{float(np.median(list(rel.values()))):.3e} on {card}", flush=True)
    if rel[worst] > GRAD_TOL or abs(loss_k - loss_p) > 1e-5 * abs(loss_p):
        fail("the kernel path's gradients disagree with the plain path's")


def paper_train_set():
    """(the pfnl preset, four seeded 12-frame 256x256 clips as sequences,
    their frame store): phase 5c's training set."""
    from pfnl_tpu_torch.config import preset
    from pfnl_tpu_torch.data.frames import MemoryFrames
    from pfnl_tpu_torch.data.manifest import Sequence

    frames, seqs = {}, []
    for s in range(4):
        clip = synthetic_clip(12, 256, 256, SEED + 10 + s)
        truth = [f"train/seq{s}/truth/{i:04d}.png" for i in range(len(clip))]
        frames.update(zip(truth, clip))
        seqs.append(Sequence(path=f"train/seq{s}", truth=truth, blur=[]))
    # save_every below is past the run, so nothing is written to save_dir
    cfg = preset("pfnl", reload=False, save_dir="pfnl_tpu_torch/build/smoke_ckpt")
    return cfg, seqs, MemoryFrames(frames)


def paper_pipeline(cfg, seqs, mem):
    """A TrainPipeline over paper_train_set()'s clips."""
    from pfnl_tpu_torch.data.pipeline import TrainPipeline

    return TrainPipeline(seqs, cfg.producer, cfg.num_frames, cfg.in_size, cfg.scale,
                         cfg.batch_size, seed=cfg.seed, num_threads=cfg.host_threads,
                         prefetch=cfg.prefetch, source=mem)


def phase_train_fit(card):
    """5c: Trainer.fit at the paper config over seeded in-memory clips."""
    from pfnl_tpu_torch.ops.cuda import KERNELS, launches, reset_launches
    from pfnl_tpu_torch.train.trainer import Trainer

    cfg, seqs, mem = paper_train_set()
    out = {}
    for plain in (False, True):
        tr = Trainer(cfg, model=paper_model(SEED), device="cuda", plain=plain)
        pipe = paper_pipeline(cfg, seqs, mem)
        logged = []

        def log(line):
            logged.append(line)
            print(f"[5c fit] {line}", flush=True)

        try:
            tr.fit(pipe, max_steps=FIT_WARM, save_every=10**9, log_every=10**9, print_fn=log)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            tr.fit(pipe, max_steps=FIT_WARM + FIT_STEPS, save_every=10**9, log_every=5,
                   print_fn=log)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            pipe.close()
        counts = {k: launches[k] for k in KERNELS}
        peak = torch.cuda.max_memory_allocated()
        losses = [float(line.rsplit("loss:", 1)[1]) for line in logged if "loss:" in line]
        finite = all(np.isfinite(losses)) and all(torch.isfinite(p).all()
                                                 for p in tr.model.parameters())
        path = "plain" if plain else "kernels"
        print(f"[5c fit] {path}: {FIT_STEPS} steps after {FIT_WARM} in {wall:.3f} s: steady "
              f"{FIT_STEPS / wall:.3f} steps/s ({TRAIN_B * FIT_STEPS / wall:.1f} clips/s); "
              f"peak memory {peak / 2**30:.2f} GiB; losses {losses}; launches per step "
              f"{ {k: v / FIT_STEPS for k, v in counts.items()} } on {card}", flush=True)
        if not finite or not losses:
            fail(f"{path}: non-finite or missing losses {losses}")
        want = {k: 0 for k in KERNELS}
        if not plain:
            want.update(pfrb_a=20, pfrb_b=20, pfnl_tail=1, pfrb_bwd_b=20, pfrb_bwd_a=20)
        if any(counts[k] != want[k] * FIT_STEPS for k in KERNELS):
            fail(f"{path}: launch counts {counts} != {want} x {FIT_STEPS} steps")
        out[path] = dict(counts=counts, steps_per_s=FIT_STEPS / wall, peak=peak)
        del tr
        torch.cuda.empty_cache()
    print(f"[5c fit] steady steps/s: kernels {out['kernels']['steps_per_s']:.3f}, plain "
          f"{out['plain']['steps_per_s']:.3f} (batch {TRAIN_B}, LR {TRAIN_HW}x{TRAIN_HW}, "
          f"float32, TF32 off) on {card}", flush=True)
    return out["kernels"]


def degraded_clip():
    """The seeded clip degraded on the device to 180x320, as uint8 blur4/
    frames in memory, and the float frames the Predictor reads from them."""
    from pfnl_tpu_torch.infer.predictor import to_uint8_img
    from pfnl_tpu_torch.ops.degrade import downsample_4d

    clip = synthetic_clip(CLIP_FRAMES, H * 4, W * 4, SEED)
    with torch.inference_mode():
        lr = downsample_4d(torch.from_numpy(clip).cuda().float() / 255.0, scale=4)
    lr_u8 = to_uint8_img(lr.cpu().numpy())
    lr_frames = {f"clip/blur4/{i:04d}.png": lr_u8[i] for i in range(CLIP_FRAMES)}
    return lr_frames, lr_u8.astype(np.float32) / 255.0


def phase_y_serving(card, lr_frames, lrs):
    """6: each Y family serves the degraded clip through test_video_lr."""
    from pfnl_tpu_torch.infer.predictor import MemoryFrames, Predictor, _clipped_windows
    from pfnl_tpu_torch.infer.profile_serving import seeded_model
    from pfnl_tpu_torch.ops.cuda import KERNELS, launches, reset_launches
    from pfnl_tpu_torch.ops.resize import resize_bicubic

    hr_h, hr_w = H * 4, W * 4
    n_batches = -(-CLIP_FRAMES // BATCH_WINDOWS)
    total = {k: 0 for k in KERNELS}
    for fam, (splat_kernel, adds_bicubic) in Y_FAMILIES.items():
        model = seeded_model(fam, torch.bfloat16, SEED)
        mem = MemoryFrames(lr_frames)
        pred = Predictor(model, batch_windows=BATCH_WINDOWS, source=mem, sink=mem)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        chunk_s = pred.test_video_lr("clip", name="sr")
        wall = time.perf_counter() - t0
        counts = {k: launches[k] for k in KERNELS}
        peak = torch.cuda.max_memory_allocated()
        want = {k: 0 for k in KERNELS}
        want[splat_kernel] = 1
        print(f"[6 {fam}] launches over {n_batches} forward batches: "
              f"{ {k: v for k, v in counts.items() if v} }", flush=True)
        if any(counts[k] != want[k] * n_batches for k in KERNELS):
            fail(f"{fam}: launch counts {counts} != {want} x {n_batches} batches")
        outs = mem.list("clip/sr")
        if len(outs) != CLIP_FRAMES:
            fail(f"{fam}: {len(outs)} SR frames written, want {CLIP_FRAMES}")
        for p in outs:
            img = mem.read(p)
            if img.shape != (hr_h, hr_w, 3) or img.dtype != np.uint8:
                fail(f"{fam} {p}: {img.shape} {img.dtype}, want ({hr_h}, {hr_w}, 3) uint8")
        fps = (CLIP_FRAMES - BATCH_WINDOWS) / float(np.sum(chunk_s[1:]))
        print(f"[6 {fam}] {CLIP_FRAMES} HR frames {hr_h}x{hr_w} in {wall:.2f} s wall (batches "
              f"{', '.join(f'{s:.3f}' for s in chunk_s)} s); steady {fps:.2f} HR frames/s; peak "
              f"memory {peak / 2**30:.2f} GiB on {card}", flush=True)
        forward_alone(f"6 {fam}", model, lrs, fps, card)

        # the first window: bf16 kernels and f32 kernels vs the float32 plain path, TF32
        # off; on the whole SR and on the trunk's part of it (SR less bicubic(centre Y))
        x = torch.from_numpy(lrs[_clipped_windows(CLIP_FRAMES, model.num_frames)[0]][None]).cuda()
        ref_model = type(model)(dtype=torch.float32).cuda().eval()
        ref_model.load_state_dict(model.state_dict())
        kw = model.serve_kwargs
        with torch.inference_mode():
            got = model(x, **kw)["sr"]
            got32 = ref_model(x, **kw)["sr"]
            ref_out = ref_model(x, plain=True, **kw)
        torch.cuda.synchronize()
        ref = ref_out["sr"]
        if got.shape != (1, 1, hr_h, hr_w, 1) or not torch.isfinite(got).all():
            fail(f"{fam}: SR of the first window: shape {tuple(got.shape)} or non-finite values")
        trunk = ref - resize_bicubic(ref_out["ref_y"], (hr_h, hr_w))[:, None] if adds_bicubic else ref
        rel = ((got - ref).norm() / ref.norm()).item()
        rel_trunk = ((got - ref).norm() / trunk.norm()).item()
        rel_trunk32 = ((got32 - ref).norm() / trunk.norm()).item()
        share = (trunk.norm() / ref.norm()).item()
        print(f"[6 {fam}] first window, bf16 kernels vs f32 plain: rel L2 err {rel:.3e} "
              f"(tolerance {E2E_TOL:.0e}), of the trunk's part {rel_trunk:.3e} (tolerance "
              f"{TRUNK_TOL['bfloat16']:.0e}; |trunk| / |SR| {share:.3e}), max abs err "
              f"{(got - ref).abs().max().item():.3e}, max|SR| {ref.abs().max().item():.3e}; "
              f"f32 kernels vs f32 plain, the trunk's part: {rel_trunk32:.3e} (tolerance "
              f"{TRUNK_TOL['float32']:.0e})", flush=True)
        if rel > E2E_TOL or rel_trunk > TRUNK_TOL["bfloat16"]:
            fail(f"{fam}: bf16 kernel path disagrees with the f32 plain path")
        if rel_trunk32 > TRUNK_TOL["float32"]:
            fail(f"{fam}: f32 kernel path disagrees with the f32 plain path")
        for k in KERNELS:
            total[k] += counts[k]
        del model, ref_model, pred
        torch.cuda.empty_cache()
    return total


def _duf_case(gen, f, g, mode, lo, hi, dt):
    """A block's parameters, and a [B,7,H,W,F+G+16] buffer of dt that holds
    values in the block's input window (planes [lo, hi), channels < F) and
    NaN everywhere else."""
    from pfnl_tpu_torch.ops.duf_ref import BlockParams

    p = BlockParams(sa=torch.rand(f, generator=gen, device="cuda") + 0.5,
                    oa=_rand((f,), gen, 0.3), wa=_rand((f, f), gen, f ** -0.5),
                    sb=torch.rand(f, generator=gen, device="cuda") + 0.5,
                    ob=_rand((f,), gen, 0.3), wb=_rand((3, 3, 3, f, g), gen, (27 * f) ** -0.5),
                    bb=_rand((g,), gen, 0.1), mode=mode)
    buf = torch.full((B, T, H, W, f + g + 16), float("nan"), device="cuda", dtype=dt)
    buf[:, lo:hi, :, :, :f] = _rand((B, hi - lo, H, W, f), gen, dist="uniform").to(dt)
    return p, buf


def _bits(x):
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


def _timed(kernel, plain):
    """(kernel ms, plain ms), each the mean of two runs of 3 calls taken in
    turns plain, kernel, kernel, plain, after a warm-up."""
    kernel(), plain()
    p1 = cuda_time_ms(plain)
    k1, k2 = cuda_time_ms(kernel), cuda_time_ms(kernel)
    p2 = cuda_time_ms(plain)
    return (k1 + k2) / 2, (p1 + p2) / 2


def phase_duf_kernels(card):
    """7a: kernels 9 and 10 against their plain versions at DUF's shapes."""
    from pfnl_tpu_torch.ops.cuda.duf_block import dense_block
    from pfnl_tpu_torch.ops.cuda.duf_dense import duf_dense
    from pfnl_tpu_torch.ops.duf_ref import block_out_planes, conv3x3x3_ref, dense_block_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    results = {}
    for label, f, g, mode, lo, hi in DUF_CASES:
        olo, ohi = block_out_planes(mode, lo, hi)
        n_in, n_out, hw = hi - lo, ohi - olo, B * H * W
        new = (slice(None), slice(olo, ohi), slice(None), slice(None), slice(f, f + g))
        conv_flop = 2.0 * hw * n_out * 27 * f * g
        flop = {"duf_block": 2.0 * hw * n_in * f * f + conv_flop, "duf_dense": conv_flop}
        for dt in (torch.float32, torch.bfloat16):
            key = str(dt).replace("torch.", "")
            p, buf = _duf_case(gen, f, g, mode, lo, hi, dt)
            scratch = torch.full((hw * n_in * f,), float("nan"), device="cuda", dtype=dt)
            got, again, ref = buf.clone(), buf.clone(), buf.clone()
            dense_block(got, p, lo, hi, scratch)
            dense_block(again, p, lo, hi, scratch)
            dense_block_ref(ref, p, lo, hi)
            same9 = torch.equal(_bits(got), _bits(again)) if "duf_block" in BITWISE_KERNELS else None
            x = buf[:, lo:hi, :, :, :f].contiguous()
            got10, ref10 = duf_dense(x, p.wb, mode == "thw"), conv3x3x3_ref(x, p.wb, mode == "thw")
            same10 = torch.equal(got10, duf_dense(x, p.wb, mode == "thw"))
            torch.cuda.synchronize()
            written = torch.zeros(buf.shape, dtype=torch.bool, device="cuda")
            written[new] = True
            finite = bool(torch.isfinite(got[new]).all())
            kept = torch.equal(_bits(got)[~written], _bits(buf)[~written])
            errs = {"duf_block": _max_errs(got[new], ref[new]), "duf_dense": _max_errs(got10, ref10)}
            for name, (abs_err, rel_err) in errs.items():
                ok = rel_err <= TOL[key]
                extra = (f"; new channels finite: {finite}, the rest of the NaN-poisoned buffer "
                         f"bitwise unchanged: {kept}; bitwise equal over two launches: {same9}"
                         ) if name == "duf_block" else (
                             f"; bitwise equal over two launches: {same10}")
                print(f"[7a kernel] {name} {label} (F {f}, G {g}, {mode}, planes [{lo},{hi})) "
                      f"{key}: max_abs_err {abs_err:.3e}, max_rel_err {rel_err:.3e} (tolerance "
                      f"{TOL[key]:.0e} of max|plain|) {'ok' if ok else 'DISAGREES'}{extra}",
                      flush=True)
                if not ok:
                    fail(f"{name} {label} {key} disagrees with its plain version")
            if not (finite and kept):
                fail(f"duf_block {label} {key}: read outside its window or wrote outside [F, F+G)")
            if not same10:
                fail(f"duf_dense {label} {key}: two launches differ")
            if same9 is False:
                fail(f"duf_block {label} {key}: two launches differ")
            if dt != torch.bfloat16:
                continue
            wc = p.wb.to(dt).permute(4, 3, 0, 1, 2)
            xc = x.permute(0, 4, 1, 2, 3)
            pad = (1 if mode == "thw" else 0, 1, 1)
            library = lambda: torch.nn.functional.conv3d(xc, wc, padding=pad)
            library_ms = (cuda_time_ms(library) + cuda_time_ms(library)) / 2
            times = {
                "duf_block": _timed(lambda: dense_block(got, p, lo, hi, scratch),
                                    lambda: dense_block_ref(ref, p, lo, hi)),
                "duf_dense": _timed(lambda: duf_dense(x, p.wb, mode == "thw"),
                                    lambda: conv3x3x3_ref(x, p.wb, mode == "thw"))}
            params = nbytes(*p[:7])
            nbyte = {"duf_block": nbytes(x, got[new]) + params,
                     "duf_dense": nbytes(x, got10, p.wb)}
            for name, (ms, plain_ms) in times.items():
                bound_ms, bound_by = bound(flop[name], nbyte[name], key)
                lib = library_ms if name == "duf_dense" else None
                lib_note = (f", F.conv3d {lib:.3f} ms (kernel / library {ms / lib:.3f})"
                            if lib is not None else "")
                print(f"[7a time] {name} {label} bf16 [{B},{n_in},{H},{W},{f}] -> G {g}: kernel "
                      f"{ms:.3f} ms ({flop[name] / ms / 1e9:.2f} TFLOP/s), plain {plain_ms:.3f} ms"
                      f"{lib_note}; bound {bound_ms:.3f} ms ({bound_by}; {flop[name] / 1e9:.1f} "
                      f"GFLOP, {nbyte[name] / 1e6:.1f} MB) on {card}", flush=True)
                if label == DUF_TIMED:
                    results[name] = dict(max_abs_err=errs[name][0], ms=ms, plain_ms=plain_ms,
                                         bound_ms=bound_ms, bound_by=bound_by, library_ms=lib)
            del got, again, ref, buf, scratch, x
            torch.cuda.empty_cache()
    return results


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


def phase_duf_serving(card, lr_frames, lrs):
    """7b: DUF-52L serves the degraded clip through test_video_lr; then the
    first window on the kernel paths against the float32 plain path."""
    from pfnl_tpu_torch.infer.predictor import MemoryFrames, Predictor, _clipped_windows
    from pfnl_tpu_torch.infer.profile_serving import seeded_model
    from pfnl_tpu_torch.models import DUF
    from pfnl_tpu_torch.ops.cuda import KERNELS, launches, reset_launches

    hr_h, hr_w = H * 4, W * 4
    n_batches = -(-CLIP_FRAMES // BATCH_WINDOWS)
    model = seeded_model("duf", torch.bfloat16, SEED)
    mem = MemoryFrames(lr_frames)
    pred = Predictor(model, batch_windows=BATCH_WINDOWS, source=mem, sink=mem)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    chunk_s = pred.test_video_lr("clip", name="sr")
    wall = time.perf_counter() - t0
    counts = {k: launches[k] for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in KERNELS}
    want["duf_block"] = len(model.G.modes)
    print(f"[7b duf] launches over {n_batches} forward batches: "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    if any(counts[k] != want[k] * n_batches for k in KERNELS):
        fail(f"duf: launch counts {counts} != {want} x {n_batches} batches")
    outs = mem.list("clip/sr")
    if len(outs) != CLIP_FRAMES:
        fail(f"duf: {len(outs)} SR frames written, want {CLIP_FRAMES}")
    for path in outs:
        img = mem.read(path)
        if img.shape != (hr_h, hr_w, 3) or img.dtype != np.uint8:
            fail(f"duf {path}: {img.shape} {img.dtype}, want ({hr_h}, {hr_w}, 3) uint8")
    fps = (CLIP_FRAMES - BATCH_WINDOWS) / float(np.sum(chunk_s[1:]))
    print(f"[7b duf] DUF-{model.layers}L: {CLIP_FRAMES} HR frames {hr_h}x{hr_w} in {wall:.2f} s "
          f"wall (batches {', '.join(f'{t:.3f}' for t in chunk_s)} s); steady {fps:.2f} HR "
          f"frames/s; peak memory {peak / 2**30:.2f} GiB on {card}", flush=True)
    forward_alone("7b duf", model, lrs, fps, card)

    x = torch.from_numpy(lrs[_clipped_windows(CLIP_FRAMES, model.num_frames)[0]][None]).cuda()
    model32 = DUF(dtype=torch.float32).cuda().eval()
    model32.load_state_dict(model.state_dict())
    with torch.inference_mode():
        sr = {"bfloat16": model(x), "float32": model32(x)}
        ref = model32(x, plain=True)
        feats = {"bfloat16": model.G.features(x.bfloat16()), "float32": model32.G.features(x)}
        ref_feat = model32.G.features(x, plain=True)
    torch.cuda.synchronize()
    if sr["bfloat16"].shape != (1, 1, hr_h, hr_w, 3) or not torch.isfinite(sr["bfloat16"]).all():
        fail(f"duf: SR of the first window: shape {tuple(sr['bfloat16'].shape)} or non-finite")
    for key in ("bfloat16", "float32"):
        rel, rel_feat = _rel(sr[key], ref), _rel(feats[key], ref_feat)
        sr_tol = E2E_TOL if key == "bfloat16" else TOL["float32"]
        print(f"[7b duf] first window, {key} kernels vs f32 plain: SR rel L2 err {rel:.3e} "
              f"(tolerance {sr_tol:.0e}), backbone output {tuple(ref_feat.shape)} rel L2 err "
              f"{rel_feat:.3e} (tolerance {BACKBONE_TOL[key]:.0e}); max|SR| "
              f"{ref.abs().max().item():.3e}, rms backbone {ref_feat.pow(2).mean().sqrt().item():.3e}",
              flush=True)
        if rel > sr_tol or rel_feat > BACKBONE_TOL[key]:
            fail(f"duf: the {key} kernel path disagrees with the f32 plain path")
    return counts, model, x, ref


def phase_duf_pallas(card, model, x, ref):
    """7c: the first window with conv3d_impl="pallas" (kernel 10 per growth conv)."""
    from pfnl_tpu_torch.models import DUF
    from pfnl_tpu_torch.ops.cuda import KERNELS, launches, reset_launches

    serving = None
    for dt in (torch.bfloat16, torch.float32):
        key = str(dt).replace("torch.", "")
        m = DUF(dtype=dt, conv3d_impl="pallas").cuda().eval()
        m.load_state_dict(model.state_dict())
        reset_launches()
        with torch.inference_mode():
            got = m(x)
        torch.cuda.synchronize()
        counts = {k: launches[k] for k in KERNELS}
        rel = _rel(got, ref)
        tol = E2E_TOL if dt == torch.bfloat16 else TOL["float32"]
        print(f"[7c duf pallas] {key}: launches { {k: v for k, v in counts.items() if v} }; SR rel "
              f"L2 err vs f32 plain {rel:.3e} (tolerance {tol:.0e}) on {card}", flush=True)
        want = {k: 0 for k in KERNELS}
        want["duf_dense"] = len(m.G.modes)
        if counts != want:
            fail(f"duf pallas: launch counts {counts} != {want}")
        if rel > tol or not torch.isfinite(got).all():
            fail(f"duf pallas: the {key} kernel-10 path disagrees with the f32 plain path")
        serving = serving or counts            # the bf16 (serving) run's
        del m
    return serving


def phase_frvsr_serving(smi, lr_frames, lrs):
    """8: FRVSR (mf 128, 10 blocks, bf16) serves the degraded clip through
    test_video_lr, frame by frame (Predictor._run_recurrent), kernel 7 at
    the HR grid [1,720,1280,3] R=1 once a frame after the first.

    The weights are seeded_model's (the init from SEED, biases N(0, 0.05^2)),
    with no further seeding: the recurrence feeds its SR back, and at full
    width its rms does not grow over the clip (held on the CPU at LR 32x48
    by tests/test_torch_frvsr.py::test_seeded_recurrence_stays_bounded), so
    the loop is bounded as drawn.  Printed here: the rms of the float32
    plain recurrence's SR at every frame.

    Gates, after the served run: K7 launched CLIP_FRAMES - 1 times and
    nothing else (in a second video too); 24 uint8 720x1280 frames; at
    every frame, teacher-forced (each path's step given the float32 plain
    recurrence's previous SR),
    the bf16 kernel path within E2E_TOL and the float32 kernel path within
    TOL["float32"] of the float32 plain path's step, relative L2.  The
    bf16 path's own recurrence against the plain one (the free-running
    drift) is printed, not gated."""
    from pfnl_tpu_torch.infer.predictor import MemoryFrames, Predictor
    from pfnl_tpu_torch.infer.profile_serving import seeded_model
    from pfnl_tpu_torch.models import FRVSR
    from pfnl_tpu_torch.ops.cuda import KERNELS, launches, reset_launches
    from torch.profiler import ProfilerActivity, profile

    hr_h, hr_w = H * 4, W * 4
    model = seeded_model("frvsr", torch.bfloat16, SEED)
    mem = MemoryFrames(lr_frames)
    pred = Predictor(model, source=mem, sink=mem)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    frame_s = pred.test_video_lr("clip", name="sr")
    wall = time.perf_counter() - t0
    counts = {k: launches[k] for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    want = {k: 0 for k in KERNELS}
    want["bounded_splat"] = CLIP_FRAMES - 1
    print(f"[8 frvsr] launches over {CLIP_FRAMES} frames: "
          f"{ {k: v for k, v in counts.items() if v} }", flush=True)
    if counts != want:
        fail(f"frvsr: launch counts {counts} != {want}")
    outs = mem.list("clip/sr")
    if len(outs) != CLIP_FRAMES:
        fail(f"frvsr: {len(outs)} SR frames written, want {CLIP_FRAMES}")
    for path in outs:
        img = mem.read(path)
        if img.shape != (hr_h, hr_w, 3) or img.dtype != np.uint8:
            fail(f"frvsr {path}: {img.shape} {img.dtype}, want ({hr_h}, {hr_w}, 3) uint8")
    fps = (CLIP_FRAMES - 1) / float(np.sum(frame_s[1:]))
    print(f"[8 frvsr] FRVSR mf {model.mf}, {model.num_blocks} blocks, bf16: {CLIP_FRAMES} HR frames "
          f"{hr_h}x{hr_w} in {wall:.2f} s wall (frame 0 {frame_s[0]:.3f} s, then "
          f"{', '.join(f'{t:.3f}' for t in frame_s[1:])} s); delivered {fps:.2f} HR frames/s "
          f"after frame 0; peak memory {peak / 2**30:.2f} GiB on {smi}", flush=True)
    # frame 0 runs the trunk alone, so the recurrent step's first-time costs (cuDNN plans of
    # the flow net's shapes, allocations) land in the first chunk; a second video finds them
    reset_launches()
    warm_s = pred.test_video_lr("clip", name="sr_again")
    if {k: launches[k] for k in KERNELS} != want:
        fail(f"frvsr, second video: launch counts {dict(launches)} != {want}")
    fps_warm = (CLIP_FRAMES - 1) / float(np.sum(warm_s[1:]))
    print(f"[8 frvsr] the same clip again: frame 0 {warm_s[0]:.3f} s, then "
          f"{', '.join(f'{t:.3f}' for t in warm_s[1:])} s; delivered {fps_warm:.2f} HR frames/s "
          f"after frame 0 on {smi}", flush=True)

    x = torch.from_numpy(lrs).cuda()  # [F,h,w,3] float32
    n = CLIP_FRAMES - 1

    def steps(sr):
        for t in range(1, CLIP_FRAMES):
            sr = model.step(x[t:t + 1], x[t - 1:t], sr)
        return sr

    with torch.inference_mode():
        sr0 = model.step(x[0:1])
        steps(sr0)  # warm-up
        fwd_ms = (cuda_time_ms(lambda: steps(sr0), 1) + cuda_time_ms(lambda: steps(sr0), 1)) / 2 / n
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        steps(sr0)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            steps(sr0)
            torch.cuda.synchronize()
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3 / n
    # where the host's time of a step goes: the operators with the most self CPU time
    host_ops = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU),
                      key=lambda e: -e.self_cpu_time_total)[:8]
    print("[8 frvsr] host ops by self CPU time a frame (under the profiler): " + ", ".join(
        f"{e.key} {e.self_cpu_time_total / 1e3 / n:.3f} ms ({e.count // n} calls)"
        for e in host_ops), flush=True)
    host_ms, done_ms = (t1 - t0) * 1e3 / n, (t2 - t0) * 1e3 / n
    print(f"[8 frvsr] forward alone {fwd_ms:.3f} ms a frame ({1e3 / fwd_ms:.2f} HR frames/s; CUDA "
          f"events around {n} back-to-back steps) beside delivered {fps:.2f} HR frames/s "
          f"({fps * fwd_ms / 1e3:.1%} of the forward's rate); device busy {busy_ms:.3f} ms a "
          f"frame ({busy_ms / fwd_ms:.1%} of the forward; torch.profiler kernel time); host: "
          f"the steps return after {host_ms:.3f} ms a frame, the device is done after "
          f"{done_ms:.3f} ms ({host_ms / done_ms:.1%}) on {smi}", flush=True)

    ref_model = FRVSR(dtype=torch.float32).cuda().eval()
    ref_model.load_state_dict(model.state_dict())
    worst = {"bfloat16": 0.0, "float32": 0.0}
    drift, rms = [], []
    with torch.inference_mode():
        ref = free = None
        for t in range(CLIP_FRAMES):
            prev = () if t == 0 else (x[t - 1:t], ref)
            got = {"bfloat16": model.step(x[t:t + 1], *prev),
                   "float32": ref_model.step(x[t:t + 1], *prev)}
            free = model.step(x[t:t + 1], *(() if t == 0 else (x[t - 1:t], free)))
            ref = ref_model.step(x[t:t + 1], *prev, plain=True)
            if got["bfloat16"].shape != (1, hr_h, hr_w, 3) or not torch.isfinite(
                    got["bfloat16"]).all():
                fail(f"frvsr frame {t}: shape {tuple(got['bfloat16'].shape)} or non-finite SR")
            for key in worst:
                worst[key] = max(worst[key], _rel(got[key], ref))
            drift.append(_rel(free, ref))
            rms.append(ref.pow(2).mean().sqrt().item())
    torch.cuda.synchronize()
    print(f"[8 frvsr] teacher-forced steps vs the f32 plain path over {CLIP_FRAMES} frames: worst "
          f"rel L2 bf16 kernels {worst['bfloat16']:.3e} (tolerance {E2E_TOL:.0e}), f32 kernels "
          f"{worst['float32']:.3e} (tolerance {TOL['float32']:.0e}); free-running bf16 drift "
          f"{', '.join(f'{d:.3e}' for d in drift)}; rms SR of the plain recurrence "
          f"{', '.join(f'{r:.4f}' for r in rms)}", flush=True)
    if worst["bfloat16"] > E2E_TOL or worst["float32"] > TOL["float32"]:
        fail("frvsr: a kernel path's step disagrees with the f32 plain path's")
    del model, ref_model, pred, x
    torch.cuda.empty_cache()
    return counts


def _busy_ms(step_fn, batches, top=3):
    """The device's kernel time a step by torch.profiler over pre-fetched
    batches, and the host operators with the most self CPU time, and the
    device time's split by kind of kernel (profile_serving's categories)."""
    from pfnl_tpu_torch.infer.profile_serving import _category
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches:
            step_fn(b)
        torch.cuda.synchronize()
    events = prof.key_averages()
    device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in device) / 1e3 / len(batches)
    split = {}
    for e in device:
        split[_category(e.key)] = split.get(_category(e.key), 0) + e.self_device_time_total
    total = max(sum(split.values()), 1e-9)
    host = sorted((e for e in events if e.device_type == torch.autograd.DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)[:top]
    return busy, ", ".join(f"{e.key} {e.self_cpu_time_total / 1e3 / len(batches):.3f} ms "
                           f"({e.count // len(batches)} calls)" for e in host) + (
        "; device time by kind: " + ", ".join(f"{k} {v / total:.1%}" for k, v in
                                              sorted(split.items(), key=lambda kv: -kv[1])))


def in_memory_set(tag, n_seqs, frames, h, w, seed):
    """Seeded clips as uint8 truth/ frames and blur4/ frames degraded on the
    card, in memory: (MemoryFrames, [Sequence])."""
    from pfnl_tpu_torch.data.frames import MemoryFrames
    from pfnl_tpu_torch.data.manifest import Sequence
    from pfnl_tpu_torch.infer.predictor import to_uint8_img
    from pfnl_tpu_torch.ops.degrade import downsample_4d

    store, seqs = {}, []
    for s in range(n_seqs):
        clip = synthetic_clip(frames, h, w, seed + s)
        with torch.inference_mode():
            lr = downsample_4d(torch.from_numpy(clip).cuda().float() / 255.0, scale=4)
        truth = [f"{tag}/seq{s}/truth/{i:04d}.png" for i in range(frames)]
        blur = [f"{tag}/seq{s}/blur4/{i:04d}.png" for i in range(frames)]
        store.update(zip(truth, clip))
        store.update(zip(blur, to_uint8_img(lr.cpu().numpy())))
        seqs.append(Sequence(path=f"{tag}/seq{s}", truth=truth, blur=blur))
    return MemoryFrames(store), seqs


@contextlib.contextmanager
def timed_adjoints(events):
    """Record CUDA events around every call of the splats' adjoints (the
    backward of BoundedSplat / SpmcSplat) into `events`."""
    from pfnl_tpu_torch.ops import warp

    saved = warp.bounded_splat_adjoint, warp.spmc_splat_adjoint

    def timed(fn):
        def call(*args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            events.append((start, end))
            return out
        return call

    warp.bounded_splat_adjoint, warp.spmc_splat_adjoint = map(timed, saved)
    try:
        yield
    finally:
        warp.bounded_splat_adjoint, warp.spmc_splat_adjoint = saved


def _flow_cfg(family):
    """The family's paper config, float32; the four staged families switch
    two steps into phase 9b's timed window."""
    from pfnl_tpu_torch.config import preset

    staged = family != "frvsr"
    return preset(family, reload=False, save_dir="pfnl_tpu_torch/build/smoke_ckpt",
                  stage_switch_step=FLOW_WARM + 2 if staged else None)


def _flow_gradients(family, cfg, batch, card):
    """9a: one fixed batch through the family at full width: the kernel
    path's joint loss and every gradient against pure autograd on the plain
    path; returns the adjoints' ms in the kernel path's backward."""
    from pfnl_tpu_torch.data.pipeline import device_augment_and_degrade
    from pfnl_tpu_torch.infer.profile_serving import seeded_model
    from pfnl_tpu_torch.ops.cuda import KERNELS, launches, reset_launches
    from pfnl_tpu_torch.train.losses import LOSS_REGISTRY

    model = seeded_model(family, torch.float32, SEED, num_frames=cfg.num_frames).train()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lr_in, gt = device_augment_and_degrade({k: torch.as_tensor(v).cuda() for k, v in batch.items()},
                                           gen, cfg.producer, cfg.scale)
    res, events = {}, []
    for path in ("warm-up", "kernels", "plain"):
        model.zero_grad(set_to_none=True)
        reset_launches()
        with timed_adjoints(events if path == "kernels" else []):
            loss = LOSS_REGISTRY[family](model(lr_in, plain=path == "plain"), gt, lr_in)["loss"]
            loss.backward()
        torch.cuda.synchronize()
        res[path] = (loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()},
                     {k: launches[k] for k in KERNELS if launches[k]})
    adjoint_ms = sum(a.elapsed_time(b) for a, b in events)
    want, adjoints = FLOW_FAMILIES[family]
    if res["kernels"][2] != want or res["plain"][2] or len(events) != adjoints:
        fail(f"{family}: launches, kernel path {res['kernels'][2]} (want {want}), plain path "
             f"{res['plain'][2]} (want none); {len(events)} adjoint calls (want {adjoints})")
    rel = {k: ((res["kernels"][1][k] - g).norm() / g.norm()).item()
           for k, g in res["plain"][1].items()}
    worst = max(rel, key=rel.get)
    loss_k, loss_p = res["kernels"][0], res["plain"][0]
    print(f"[9a {family}] batch {cfg.batch_size}, {cfg.num_frames} frames, LR "
          f"{cfg.in_size}x{cfg.in_size}, float32: launches {want}; joint loss kernels "
          f"{loss_k:.7f}, plain {loss_p:.7f}; worst ||g_k - g_p|| / ||g_p|| over {len(rel)} "
          f"parameters {rel[worst]:.3e} ({worst}; tolerance {GRAD_TOL:.0e}), median "
          f"{float(np.median(list(rel.values()))):.3e}; the splat adjoints "
          f"{adjoint_ms:.3f} ms in a backward ({len(events)} calls) on {card}", flush=True)
    if rel[worst] > GRAD_TOL or abs(loss_k - loss_p) > 1e-5 * abs(loss_p):
        fail(f"{family}: the kernel path's gradients disagree with the plain path's")
    del model, res
    torch.cuda.empty_cache()
    return adjoint_ms


def _flow_fit(family, cfg, pipe, plain, card):
    """9b: Trainer.fit at the paper config across the stage switch: launches
    a step, finite losses, steady steps/s and peak memory; on the kernel path
    also the device's busy ms a step (torch.profiler over pre-fetched steps)."""
    from pfnl_tpu_torch.infer.profile_serving import seeded_model
    from pfnl_tpu_torch.ops.cuda import KERNELS, launches, reset_launches
    from pfnl_tpu_torch.train.trainer import Trainer

    path = "plain" if plain else "kernels"
    tr = Trainer(cfg, model=seeded_model(family, torch.float32, SEED,
                                         num_frames=cfg.num_frames).train(),
                 device="cuda", plain=plain)
    logged = []

    def log(line):
        logged.append(line)

    tr.fit(pipe, max_steps=FLOW_WARM, save_every=10**9, log_every=10**9, print_fn=log)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    tr.fit(pipe, max_steps=FLOW_WARM + FLOW_STEPS, save_every=10**9, log_every=2, print_fn=log)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: launches[k] for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(line.rsplit("loss:", 1)[1]) for line in logged if "loss:" in line]
    finite = all(np.isfinite(losses)) and all(torch.isfinite(p).all()
                                             for p in tr.model.parameters())
    want = {k: 0 if plain else FLOW_FAMILIES[family][0].get(k, 0) * FLOW_STEPS for k in KERNELS}
    if not finite or not losses:
        fail(f"{family} {path}: non-finite or missing losses {losses}")
    if counts != want:
        fail(f"{family} {path}: launch counts {counts} != {want} over {FLOW_STEPS} steps")
    if tr.stage != int(cfg.stage_switch_step is not None):
        fail(f"{family} {path}: stage {tr.stage} after step {tr.global_step}")
    step_ms = wall * 1e3 / FLOW_STEPS
    busy = ""
    if not plain:
        busy_ms, host_ops = _busy_ms(lambda b: tr.step(b, tr.step_generator(tr.global_step)),
                                     [pipe.get_batch() for _ in range(3)], top=5)
        busy = (f"; device busy {busy_ms:.3f} ms a step ({busy_ms / step_ms:.1%} of the steady "
                f"step; torch.profiler kernel time over 3 pre-fetched steps); host ops by self "
                f"CPU time a step (under the profiler): {host_ops}")
    switch = ("single stage" if cfg.stage_switch_step is None
              else f"the switch at step {cfg.stage_switch_step}")
    print(f"[9b {family}] {path}: {FLOW_STEPS} steps after {FLOW_WARM} ({switch}) in {wall:.3f} s: steady {FLOW_STEPS / wall:.3f} steps/s "
          f"({step_ms:.3f} ms a step); peak memory {peak / 2**30:.2f} GiB; losses {losses}; "
          f"launches per step { {k: v / FLOW_STEPS for k, v in counts.items() if v} }{busy} "
          f"on {card}", flush=True)
    del tr
    torch.cuda.empty_cache()
    return counts, FLOW_STEPS / wall


def phase_flow_training(card):
    """9: the five flow families' paper configs on seeded in-memory clips
    through TrainPipeline: 9a the gradients on one batch, 9b Trainer.fit on
    the kernel and the plain path."""
    from pfnl_tpu_torch.data.pipeline import TrainPipeline
    from pfnl_tpu_torch.ops.cuda import KERNELS

    n_seqs, frames, hw = FLOW_CLIP
    mem, seqs = in_memory_set("flow", n_seqs, frames, hw, hw, SEED + 20)
    total = {k: 0 for k in KERNELS}
    for family in FLOW_FAMILIES:
        cfg = _flow_cfg(family)
        pipe = TrainPipeline(seqs, cfg.producer, cfg.num_frames, cfg.in_size, cfg.scale,
                             cfg.batch_size, seed=cfg.seed, num_threads=cfg.host_threads,
                             prefetch=cfg.prefetch, source=mem)
        try:
            adjoint_ms = _flow_gradients(family, cfg, pipe.get_batch(), card)
            counts, rate = _flow_fit(family, cfg, pipe, False, card)
            _, plain_rate = _flow_fit(family, cfg, pipe, True, card)
        finally:
            pipe.close()
        for k in KERNELS:
            total[k] += counts[k]
        print(f"[9 {family}] steady steps/s: kernels {rate:.3f}, plain {plain_rate:.3f}; the "
              f"splat adjoints {adjoint_ms:.3f} ms a step (batch {cfg.batch_size}, float32, "
              f"TF32 off) on {card}", flush=True)
    return total


def phase_eval(card):
    """10: the Evaluator on the card, every family at full width (float32,
    seeded weights), one batch of 4 windows at eval_in_size 128x240 over 4
    seeded 20-frame sequences in memory: finite PSNR, the kernels' launches
    a batch, and for the Y families one frame's SSIM on the card against
    the float64 host SSIM."""
    from pfnl_tpu_torch.config import preset
    from pfnl_tpu_torch.eval.evaluator import Evaluator
    from pfnl_tpu_torch.eval.metrics import compute_ssim, compute_ssim_batch
    from pfnl_tpu_torch.infer.profile_serving import seeded_model
    from pfnl_tpu_torch.ops.color import rgb2y
    from pfnl_tpu_torch.ops.cuda import KERNELS, launches, reset_launches

    in_h, in_w = preset("pfnl").eval_in_size
    mem, seqs = in_memory_set("eval", 4, 20, in_h * 4 + 16, in_w * 4 + 16, SEED + 30)
    total = {k: 0 for k in KERNELS}
    for family, want in EVAL_LAUNCHES.items():
        cfg = preset(family, reload=False)
        model = seeded_model(family, torch.float32, SEED)
        ev = Evaluator(cfg, model, source=mem, sequences=seqs)
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        got = ev.run(0, print_fn=lambda *a: None)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = {k: launches[k] for k in KERNELS}
        for k in KERNELS:
            total[k] += counts[k]
        psnr = got[0]
        note = ""
        if len(got) == 3:
            lr, gt = next(ev._windows())
            with torch.inference_mode():
                sr = model(torch.from_numpy(lr[None]).cuda())["sr"][0, -1, :, :, 0]
                gt_y = rgb2y(torch.from_numpy(gt).cuda())[0, :, :, 0]
                card_ssim = compute_ssim_batch(sr, gt_y, l=1.0).item()
            host_ssim = compute_ssim(sr.double().cpu().numpy(), gt_y.double().cpu().numpy(),
                                     l=1.0)
            note = (f", SSIM {got[2].tolist()}; one frame's SSIM on the card {card_ssim:.7f}, "
                    f"float64 on the host {host_ssim:.7f} (tolerance {SSIM_TOL:.0e})")
            if abs(card_ssim - host_ssim) > SSIM_TOL:
                fail(f"eval {family}: the card's SSIM {card_ssim} != the host's {host_ssim}")
        print(f"[10 eval] {family}: 4 windows in {wall:.3f} s, PSNR {psnr.tolist()}{note}; "
              f"launches { {k: v for k, v in counts.items() if v} } on {card}", flush=True)
        if not np.all(np.isfinite(psnr)):
            fail(f"eval {family}: PSNR {psnr}")
        if counts != {k: want.get(k, 0) for k in KERNELS}:
            fail(f"eval {family}: launch counts {counts} != {want} for one batch")
        del model, ev
        torch.cuda.empty_cache()
    return total


def _duf_gradients(cfg, batch, card):
    """11a: one fixed batch through DUF-52L in training mode from the same
    weights and BatchNorm buffers: kernel 10 under autograd (`Conv3x3x3`)
    against pure autograd on the plain path: the loss, every gradient, and
    the five buffers after the step.  A training BatchNorm's backward turns
    float32 rounding into gradient differences of about 1e-3 between any
    two float32 evaluations of the same step, so each gradient is held
    within GRAD_TOL or within NOISE_FACTOR times the most that float32
    alone moves it here, whichever is larger, taken from the plain path
    only: what reversing the batch order does there (the same function
    summed in another order) and what PyTorch's native conv in place of
    cuDNN's does (another float32 conv, as kernel 10 is).  The kernel
    path's own reading with the batch reversed is printed beside the limit
    and kept out of it, so that a fault that depends on where a sample sits
    in the batch cannot widen its own limit.  The biases a BatchNorm
    cancels, 0 in exact arithmetic, are measured over the median gradient
    norm."""
    from pfnl_tpu_torch.data.pipeline import device_augment_and_degrade
    from pfnl_tpu_torch.infer.profile_serving import seeded_model
    from pfnl_tpu_torch.models.duf import bn_cancelled_bias
    from pfnl_tpu_torch.ops.cuda import KERNELS, launches, reset_launches
    from pfnl_tpu_torch.train.losses import LOSS_REGISTRY

    model = seeded_model("duf", torch.float32, SEED, conv3d_impl="pallas").train()
    state0 = {k: v.clone() for k, v in model.state_dict().items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    lr_in, gt = device_augment_and_degrade({k: torch.as_tensor(v).cuda() for k, v in batch.items()},
                                           gen, cfg.producer, cfg.scale)
    res = {}
    for path in ("warm-up", "kernels", "plain", "kernels reversed", "plain reversed",
                 "plain, no cuDNN"):
        x, y = (lr_in.flip(0), gt.flip(0)) if path.endswith("reversed") else (lr_in, gt)
        model.load_state_dict(state0)
        model.zero_grad(set_to_none=True)
        reset_launches()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        with torch.backends.cudnn.flags(enabled=path != "plain, no cuDNN", allow_tf32=False):
            out = model(x, plain=path.startswith("plain"))
            loss = LOSS_REGISTRY["duf"]({"sr": out}, y, x)["loss"]
            loss.backward()
        end.record()
        torch.cuda.synchronize()
        res[path] = (loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()},
                     {k: b.clone() for k, b in model.named_buffers()},
                     {k: launches[k] for k in KERNELS if launches[k]}, start.elapsed_time(end))
    want = {"duf_dense": len(model.G.modes)}
    if res["kernels"][3] != want or res["plain"][3]:
        fail(f"duf training: launches, kernel path {res['kernels'][3]} (want {want}), plain "
             f"{res['plain'][3]} (want none)")
    grads = {path: r[1] for path, r in res.items()}
    median = float(np.median([g.norm().item() for g in grads["plain"].values()]))
    err, bound, floor, k_rev = {}, {}, {}, {}
    for k, g in grads["plain"].items():
        scale = median if bn_cancelled_bias(k) else g.norm().item()
        err[k] = (grads["kernels"][k] - g).norm().item() / scale
        floor[k] = max((grads["plain reversed"][k] - g).norm().item(),
                       (grads["plain, no cuDNN"][k] - g).norm().item()) / scale
        k_rev[k] = (grads["kernels reversed"][k] - grads["kernels"][k]).norm().item() / scale
        bound[k] = max(GRAD_TOL, NOISE_FACTOR * floor[k])
    worst = max(err, key=lambda k: err[k] / bound[k])
    need = max(err, key=lambda k: err[k] / floor[k] if err[k] > GRAD_TOL else 0.0)
    buf = {k: ((res["kernels"][2][k] - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
           for k, b in res["plain"][2].items()}
    worst_buf = max(buf, key=buf.get)
    steps = {b.item() for k, b in res["kernels"][2].items() if k.endswith("local_step")}
    loss_k, loss_p = res["kernels"][0], res["plain"][0]
    print(f"[11a duf train] DUF-52L, batch {cfg.batch_size}, {cfg.num_frames} frames, LR "
          f"{cfg.in_size}x{cfg.in_size}, float32, BatchNorm in training mode: launches {want}; "
          f"Huber loss kernels {loss_k:.8f}, plain {loss_p:.8f}; ||g_k - g_p|| / ||g_p|| over "
          f"{len(err)} parameters: median {float(np.median(list(err.values()))):.3e}, worst "
          f"against its limit {err[worst]:.3e} ({worst}; limit {bound[worst]:.3e}, the kernel "
          f"path reversed moves it by {k_rev[worst]:.3e}); float32 alone on the plain path (the "
          f"batch reversed, native conv for cuDNN's) moves them by a median "
          f"{float(np.median(list(floor.values()))):.3e}, at most {max(floor.values()):.3e}; of "
          f"the gradients beyond {GRAD_TOL:.0e}, the most error over that floor is "
          f"{err[need] / floor[need] if err[need] > GRAD_TOL else 0.0:.3f} ({need}; "
          f"NOISE_FACTOR {NOISE_FACTOR}); the kernel path reversed moves them by a median "
          f"{float(np.median(list(k_rev.values()))):.3e}, at most {max(k_rev.values()):.3e} (the "
          f"{sum(map(bn_cancelled_bias, err))} biases a BatchNorm cancels over the median ||g||); "
          f"BatchNorm buffers after the step: worst max|k - p| / max|p| {buf[worst_buf]:.3e} "
          f"({worst_buf}; tolerance {BN_BUFFER_TOL:.0e}), local_step {sorted(steps)}; "
          f"forward+backward {res['kernels'][4]:.3f} ms kernels, {res['plain'][4]:.3f} ms plain, "
          f"{res['plain, no cuDNN'][4]:.3f} ms without cuDNN on {card}", flush=True)
    if (err[worst] > bound[worst] or buf[worst_buf] > BN_BUFFER_TOL or steps != {1.0}
            or abs(loss_k - loss_p) > 1e-5 * abs(loss_p)):
        fail("duf training: the kernel-10 path disagrees with plain autograd")
    del model, res, grads
    torch.cuda.empty_cache()


def _duf_train_convs(cfg, card):
    """11a: kernel 10's float32 entry at the training shape [B,7,LR,LR,F]
    (batch 11, LR 32) against F.conv3d (cuDNN, TF32 off) on the same
    inputs, at the first, a middle and the last SAME-T growth conv and the
    last VALID-T one: ms beside the float32 bound, and the error."""
    from pfnl_tpu_torch.ops.cuda.duf_dense import duf_dense
    from pfnl_tpu_torch.ops.duf_ref import conv3x3x3_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 42)
    hw = cfg.in_size
    for f, pad_t, t in ((64, True, 7), (224, True, 7), (384, True, 7), (432, False, 3)):
        x = _rand((cfg.batch_size, t, hw, hw, f), gen, dist="uniform")
        w = _rand((3, 3, 3, f, 16), gen, scale=(2 / (27 * f)) ** 0.5)
        with torch.inference_mode():
            ref = conv3x3x3_ref(x, w, pad_t)
            err = ((duf_dense(x, w, pad_t) - ref).abs().max() / ref.abs().max()).item()
            k_ms, p_ms = _timed(lambda: duf_dense(x, w, pad_t), lambda: conv3x3x3_ref(x, w, pad_t))
        t_out = t if pad_t else t - 2
        flop = 2 * 27 * f * 16 * cfg.batch_size * t_out * hw * hw
        b_ms, b_by = bound(flop, nbytes(x, w, ref), "float32")
        print(f"[11a duf train] kernel 10 float32 at [{cfg.batch_size},{t},{hw},{hw},{f}] -> G 16 "
              f"({'SAME' if pad_t else 'VALID'}-T): {k_ms:.4f} ms, F.conv3d {p_ms:.4f} ms "
              f"({k_ms / p_ms:.2f}x), bound {b_ms:.4f} ms ({b_by}); max|k - p| / max|p| {err:.2e} "
              f"(tolerance {TOL['float32']:.0e}) on {card}", flush=True)
        if err > TOL["float32"]:
            fail(f"kernel 10 float32 at F {f}: {err} off F.conv3d")


def _duf_fit(cfg, pipe, impl, card):
    """11b: Trainer.fit at the duf preset: launches a step, finite losses,
    steady steps/s, peak memory and the device's busy share."""
    from pfnl_tpu_torch.infer.profile_serving import seeded_model
    from pfnl_tpu_torch.ops.cuda import KERNELS, launches, reset_launches
    from pfnl_tpu_torch.train.trainer import Trainer

    tr = Trainer(cfg, model=seeded_model("duf", torch.float32, SEED, conv3d_impl=impl).train(),
                 device="cuda")
    logged = []
    tr.fit(pipe, max_steps=DUF_WARM, save_every=10**9, log_every=10**9, print_fn=logged.append)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    tr.fit(pipe, max_steps=DUF_WARM + DUF_STEPS, save_every=10**9, log_every=2,
           print_fn=logged.append)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: launches[k] for k in KERNELS}
    peak = torch.cuda.max_memory_allocated()
    losses = [float(line.rsplit("loss:", 1)[1]) for line in logged if "loss:" in line]
    finite = all(np.isfinite(losses)) and all(torch.isfinite(p).all()
                                             for p in tr.model.parameters())
    if not finite or not losses:
        fail(f"duf {impl}: non-finite or missing losses {losses}")
    want = {k: 0 for k in KERNELS}
    want["duf_dense"] = len(tr.model.G.modes) * DUF_STEPS if impl == "pallas" else 0
    if counts != want:
        fail(f"duf {impl}: launch counts {counts} != {want} over {DUF_STEPS} steps")
    step_ms = wall * 1e3 / DUF_STEPS
    busy, host = _busy_ms(lambda b: tr.step(b, tr.step_generator(tr.global_step)),
                          [pipe.get_batch() for _ in range(3)])
    print(f"[11b duf fit] {impl}: {DUF_STEPS} steps after {DUF_WARM} in {wall:.3f} s: steady "
          f"{DUF_STEPS / wall:.3f} steps/s ({step_ms:.3f} ms a step); peak memory "
          f"{peak / 2**30:.2f} GiB; losses {losses}; launches per step "
          f"{ {k: v / DUF_STEPS for k, v in counts.items() if v} }; device busy {busy:.3f} ms a "
          f"step ({busy / step_ms:.1%} of the steady step; torch.profiler over 3 pre-fetched "
          f"steps); host ops a step: {host} on {card}", flush=True)
    return tr, counts, DUF_STEPS / wall


def _duf_eval_after_training(cfg, model, card):
    """11c: the model Trainer.fit trained (conv3d_impl auto), through the
    Evaluator in eval mode: kernel 9 on the moving statistics that training
    made; then one window's backbone output on the kernel paths against the
    float32 plain path."""
    from pfnl_tpu_torch.eval.evaluator import Evaluator
    from pfnl_tpu_torch.models import DUF
    from pfnl_tpu_torch.ops.cuda import KERNELS, launches, reset_launches

    in_h, in_w = cfg.eval_in_size
    mem, seqs = in_memory_set("dufeval", 4, 20, in_h * 4 + 16, in_w * 4 + 16, SEED + 41)
    steps = {b.item() for k, b in model.named_buffers() if k.endswith("local_step")}
    ev = Evaluator(cfg, model, source=mem, sequences=seqs)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    psnr = ev.run(0, print_fn=lambda *a: None)[0]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {k: launches[k] for k in KERNELS}
    want = {k: 0 for k in KERNELS}
    want["duf_block"] = len(model.G.modes)
    if counts != want or not model.training or not np.all(np.isfinite(psnr)):
        fail(f"duf eval after training: launches {counts} (want {want}), training mode given "
             f"back {model.training}, PSNR {psnr}")
    lr, _ = next(ev._windows())
    x = torch.from_numpy(lr[None]).cuda()
    model.eval()
    model16 = DUF(dtype=torch.bfloat16).cuda().eval()
    model16.load_state_dict(model.state_dict())
    with torch.inference_mode():
        ref = model.G.features(x, plain=True)
        feats = {"float32": model.G.features(x), "bfloat16": model16.G.features(x.bfloat16())}
    model.train()
    rel = {k: _rel(f, ref) for k, f in feats.items()}
    print(f"[11c duf eval] after {sorted(steps)} training steps (local_step): Evaluator, 4 "
          f"windows at {in_h}x{in_w} in {wall:.3f} s, PSNR {psnr.tolist()}, launches "
          f"{ {k: v for k, v in counts.items() if v} }; backbone output {tuple(ref.shape)} on "
          f"the moving statistics vs the f32 plain path: rel L2 float32 kernels "
          f"{rel['float32']:.3e} (tolerance {BACKBONE_TOL['float32']:.0e}), bf16 kernels "
          f"{rel['bfloat16']:.3e} (tolerance {BACKBONE_TOL['bfloat16']:.0e}); rms "
          f"{ref.pow(2).mean().sqrt().item():.3e} on {card}", flush=True)
    if any(rel[k] > BACKBONE_TOL[k] for k in rel):
        fail("duf eval after training: kernel 9 disagrees with the f32 plain path")
    del model16
    return counts


def phase_duf_training(card):
    """11: DUF-52L training at the duf preset (batch 11, 7 frames, LR 32 /
    GT 128, the "double" producer, float32, TF32 off) on four seeded
    12-frame clips in memory: 11a the kernel-10 path's gradients and
    BatchNorm buffers against plain autograd on GRAD_BATCHES batches, 11b
    Trainer.fit on the default path (cuDNN) and on conv3d_impl="pallas"
    (kernel 10), 11c the Evaluator on the trained model (kernel 9)."""
    from pfnl_tpu_torch.config import preset
    from pfnl_tpu_torch.data.pipeline import TrainPipeline

    n_seqs, frames, hw = FLOW_CLIP
    mem, seqs = in_memory_set("duftrain", n_seqs, frames, hw, hw, SEED + 40)
    cfg = preset("duf", reload=False, save_dir="pfnl_tpu_torch/build/smoke_ckpt")
    pipe = TrainPipeline(seqs, cfg.producer, cfg.num_frames, cfg.in_size, cfg.scale,
                         cfg.batch_size, seed=cfg.seed, num_threads=cfg.host_threads,
                         prefetch=cfg.prefetch, source=mem)
    try:
        _duf_train_convs(cfg, card)
        for _ in range(GRAD_BATCHES):
            _duf_gradients(cfg, pipe.get_batch(), card)
        tr, _, rate = _duf_fit(cfg, pipe, "auto", card)
        pallas_tr, dense_counts, pallas_rate = _duf_fit(cfg, pipe, "pallas", card)
    finally:
        pipe.close()
    del pallas_tr
    torch.cuda.empty_cache()
    block_counts = _duf_eval_after_training(cfg, tr.model, card)
    print(f"[11 duf] steady steps/s: default (cuDNN) {rate:.3f}, kernel 10 {pallas_rate:.3f} "
          f"(batch {cfg.batch_size}, float32, TF32 off) on {card}", flush=True)
    del tr
    torch.cuda.empty_cache()
    return {k: dense_counts[k] + block_counts[k] for k in dense_counts}


def _flownet_forward(name, model, a, b, card):
    """12c: one forward at FlowNet's published input on the card (ms by CUDA
    events, peak memory) and its first pair against the same weights on
    the CPU."""
    with torch.no_grad():
        ref = model(a[:1].cpu(), b[:1].cpu())
    model.cuda()
    with torch.inference_mode():
        out = model(a, b)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_time_ms(lambda: model(a, b))
        peak = torch.cuda.max_memory_allocated()
    err = ((out[:1].cpu() - ref).abs().max() / ref.abs().max()).item()
    print(f"[12c {name}] batch {a.shape[0]} at {a.shape[1]}x{a.shape[2]}, float32: output "
          f"{tuple(out.shape)}, {ms:.3f} ms a forward, peak memory {peak / 2**30:.2f} GiB; "
          f"the first pair vs the CPU: max|card - cpu| / max|cpu| {err:.3e} (tolerance "
          f"{TOL['float32']:.0e}) on {card}", flush=True)
    if err > TOL["float32"] or not torch.isfinite(out).all():
        fail(f"{name}: the card's forward disagrees with the CPU's")


def phase_easyflow_flownet(card):
    """12: EasyFlow pre-training at the reference's config (batch 20, crop
    100, 7 frames) on seeded in-memory clips, summaries off (12a); its
    checkpoint into a VESPCN that Trainer.fit trains 3 steps (12b);
    FlowNet-S, FlowNet-C and WarpConfidence forward at 384x512, batch 8
    (12c)."""
    import glob
    import os

    from pfnl_tpu_torch.config import preset
    from pfnl_tpu_torch.data.pipeline import TrainPipeline
    from pfnl_tpu_torch.infer.profile_serving import seeded_model
    from pfnl_tpu_torch.models.flownet import FlowNetC, FlowNetS, WarpConfidence
    from pfnl_tpu_torch.ops.cuda import KERNELS, launches, reset_launches
    from pfnl_tpu_torch.train.easyflow_trainer import EasyFlowTrainer, restore_easyflow_params
    from pfnl_tpu_torch.train.trainer import Trainer

    n_seqs, frames, hw = FLOW_CLIP
    mem, seqs = in_memory_set("easyflow", n_seqs, frames, hw, hw, SEED + 50)
    save_dir = "pfnl_tpu_torch/build/smoke_ckpt/easyflow"
    for old in glob.glob(os.path.join(save_dir, "step_*.pt")):
        os.remove(old)
    ef = EasyFlowTrainer(save_dir=save_dir, num_frames=EF_FRAMES, crop_size=EF_CROP,
                         batch_size=EF_BATCH, seed=SEED, device="cuda", source=mem,
                         sequences=[s.truth for s in seqs])
    logged = []
    quiet = dict(print_fn=logged.append, summary_every=10**9, image_summary_every=0)
    ef.train(max_steps=EF_WARM, **quiet)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    ef.train(max_steps=EF_STEPS, **quiet)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    trained = {k: v.clone() for k, v in ef.model.state_dict().items()}  # the last checkpoint's
    losses = [float(line.rsplit("loss = ", 1)[1].split()[0]) / 100 for line in logged]
    if not losses or not all(np.isfinite(losses)):
        fail(f"easyflow: non-finite or missing losses {losses}")
    rng = np.random.default_rng(SEED)
    optimizer = torch.optim.Adam(ef.model.parameters(), lr=1e-6)
    busy, host = _busy_ms(lambda b: ef.step(optimizer, 0, b),
                          [ef.sample_batch(rng, ef._sequences()) for _ in range(3)])
    step_ms = wall * 1e3 / EF_STEPS
    print(f"[12a easyflow] batch {EF_BATCH}, crop {EF_CROP}, {EF_FRAMES} frames, float32: "
          f"{EF_STEPS} steps of EasyFlowTrainer.train (host sampling included) after "
          f"{EF_WARM} in {wall:.3f} s: {EF_STEPS / wall:.3f} steps/s ({step_ms:.3f} ms a step); "
          f"peak memory {peak / 2**30:.2f} GiB; losses {losses}; device busy {busy:.3f} ms a "
          f"step ({busy / step_ms:.1%} of a step); host ops a step: {host} on {card}",
          flush=True)

    cfg = preset("vespcn", reload=False, save_dir="pfnl_tpu_torch/build/smoke_ckpt")
    model = restore_easyflow_params(save_dir, seeded_model("vespcn", torch.float32, SEED).train())
    flow = {k: v.clone() for k, v in model.easyflow.state_dict().items()}
    if any(not torch.equal(v, trained[k]) for k, v in flow.items()):
        fail("easyflow: VESPCN's easyflow is not the pre-trained flow")
    pipe = TrainPipeline(seqs, cfg.producer, cfg.num_frames, cfg.in_size, cfg.scale,
                         cfg.batch_size, seed=cfg.seed, num_threads=cfg.host_threads,
                         prefetch=cfg.prefetch, source=mem)
    tr = Trainer(cfg, model=model, device="cuda")
    logged = []
    reset_launches()
    try:
        tr.fit(pipe, max_steps=3, save_every=10**9, log_every=1, print_fn=logged.append)
    finally:
        pipe.close()
    torch.cuda.synchronize()
    counts = {k: launches[k] for k in KERNELS}
    losses = [float(line.rsplit("loss:", 1)[1]) for line in logged if "loss:" in line]
    held = all(torch.equal(v, model.easyflow.state_dict()[k]) for k, v in flow.items())
    print(f"[12b easyflow -> vespcn] restore_easyflow_params, then Trainer.fit 3 steps (stage "
          f"{tr.stage}, before the switch at {cfg.stage_switch_step}: the pre-trained flow held "
          f"{held}): losses {losses}; launches { {k: v for k, v in counts.items() if v} } on "
          f"{card}", flush=True)
    want = {k: 0 for k in KERNELS}
    want["bounded_splat"] = 3
    if not losses or not all(np.isfinite(losses)) or counts != want or not held:
        fail(f"easyflow -> vespcn: losses {losses}, launches {counts} (want {want}), flow held "
             f"{held}")
    del tr, model, ef
    torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(SEED + 51)
    shape = (FLOWNET_BATCH,) + FLOWNET_HW
    rgb = [torch.rand(shape + (3,), generator=gen, device="cuda") for _ in range(2)]
    for name, cls, inputs in (("FlowNetS", FlowNetS, rgb), ("FlowNetC", FlowNetC, rgb),
                              ("WarpConfidence", WarpConfidence, [t[..., :1] for t in rgb])):
        model = cls(generator=torch.Generator().manual_seed(SEED)).eval()
        _flownet_forward(name, model, *inputs, card)
        del model
        torch.cuda.empty_cache()
    return counts


def _pfnl_nodes(program):
    """{kernel: the program's torch.ops.pfnl nodes of it}."""
    import collections

    return dict(collections.Counter(str(n.target).split(".")[1] for n in program.graph.nodes
                                    if n.op == "call_function"
                                    and str(n.target).startswith("pfnl.")))


def _export_case(tag, model, name, lrs, card):
    """13: the family's serving program exported at one window batch of the
    clip (4 windows, LR 180x320, float32 input), loaded, called once: its
    pfnl nodes and launches (EXPORT_WANT), its output against eager serve,
    and the refusal of a CPU input and of another shape; the launches of
    the export (its one eager call's: tracing counts none), the seconds of
    the export and the load, the artifact's MB, the forward ms of artifact and
    eager serve (CUDA events, 3 calls after a warm-up: eager, artifact,
    artifact, eager).  Returns the launches of the one call."""
    from pfnl_tpu_torch.infer.export import export_model, load_exported
    from pfnl_tpu_torch.infer.predictor import _clipped_windows, serve, to_uint8
    from pfnl_tpu_torch.ops.cuda import KERNELS, launches, reset_launches

    want = {k: EXPORT_WANT[name].get(k, 0) for k in KERNELS}
    x = torch.from_numpy(lrs[_clipped_windows(CLIP_FRAMES, model.num_frames)[:BATCH_WINDOWS]])
    x = x.cuda()
    reset_launches()
    t0 = time.perf_counter()
    blob = export_model(model, x.shape[0], x.shape[1], tuple(x.shape[2:4]), model_name=name)
    export_s = time.perf_counter() - t0
    traced = {k: v for k, v in launches.items() if v}
    t0 = time.perf_counter()
    fn = load_exported(blob)
    load_s = time.perf_counter() - t0
    nodes = _pfnl_nodes(fn.program)
    reset_launches()
    out = fn(x)
    torch.cuda.synchronize()
    counts = {k: launches[k] for k in KERNELS}
    with torch.inference_mode():
        ref = serve(model, x)
    got = out[:, 0] if out.dim() == 5 else out
    if got.shape != ref.shape or not torch.isfinite(out).all():
        fail(f"{tag}: artifact output {tuple(out.shape)} (or non-finite) vs serve "
             f"{tuple(ref.shape)}")
    max_abs = (got - ref).abs().max().item()
    rel = _rel(got, ref)
    steps = (to_uint8(got).int() - to_uint8(ref).int()).abs().max().item()
    with torch.inference_mode():
        serve(model, x)
        fn(x)
        e1 = cuda_time_ms(lambda: serve(model, x))
        a1 = cuda_time_ms(lambda: fn(x))
        a2 = cuda_time_ms(lambda: fn(x))
        e2 = cuda_time_ms(lambda: serve(model, x))
    art_ms, eager_ms = (a1 + a2) / 2, (e1 + e2) / 2
    refused = []
    for bad, what in ((x.cpu(), "a CPU input"), (x[:1], f"shape {tuple(x[:1].shape)}")):
        try:
            fn(bad)
        except ValueError:
            refused.append(what)
    print(f"[{tag}] {name}: export {export_s:.2f} s (launches {traced}: its eager call's), load "
          f"{load_s:.2f} s, {len(blob) / 1e6:.2f} MB; pfnl nodes {nodes}; launches a call "
          f"{ {k: v for k, v in counts.items() if v} }; output {tuple(out.shape)} vs eager serve: "
          f"max abs {max_abs:.3e}, rel L2 {rel:.3e} (tolerance {EXPORT_REL_TOL:.0e}), uint8 "
          f"steps {steps} (tolerance {EXPORT_U8_STEPS}); forward artifact {art_ms:.3f} ms "
          f"({a1:.3f}, {a2:.3f}), eager serve {eager_ms:.3f} ms ({e1:.3f}, {e2:.3f}), artifact / "
          f"eager {art_ms / eager_ms:.3f}; refused {refused} on {card}", flush=True)
    if traced != {k: v for k, v in want.items() if v}:
        fail(f"{tag}: export launched {traced}, not its one eager call's (tracing counts none)")
    if nodes != {k: v for k, v in want.items() if v} or counts != want:
        fail(f"{tag}: pfnl nodes {nodes} / launches {counts}, want {want}")
    if rel > EXPORT_REL_TOL or steps > EXPORT_U8_STEPS:
        fail(f"{tag}: the artifact disagrees with eager serve")
    if len(refused) != 2:
        fail(f"{tag}: the artifact took an input it must refuse (refused only {refused})")
    return counts


def phase_export(card, lrs):
    """13a: PFNL at phase 4's configuration; 13b: VESPCN (phase 6's) and
    DUF-52L (phase 7b's) the same way."""
    from pfnl_tpu_torch.infer.profile_serving import seeded_model
    from pfnl_tpu_torch.models.pfnl import PFNL
    from pfnl_tpu_torch.ops.cuda import KERNELS

    total = {k: 0 for k in KERNELS}
    cases = (("13a export", lambda: PFNL(dtype=torch.bfloat16,
                                         generator=torch.Generator().manual_seed(SEED)
                                         ).cuda().eval(), "pfnl"),
             ("13b export", lambda: seeded_model("vespcn", torch.bfloat16, SEED), "vespcn"),
             ("13b export", lambda: seeded_model("duf", torch.bfloat16, SEED), "duf"))
    for tag, make, name in cases:
        counts = _export_case(tag, make(), name, lrs, card)
        for k in KERNELS:
            total[k] += counts[k]
        torch.cuda.empty_cache()
    return total


def _free_port():
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dp_predictor(card):
    """14a: Predictor(devices=[cuda:0]) through sharded_apply_dp at phase 4's
    configuration, beside the single-device Predictor on the same clip:
    bitwise the same frames, the same launches."""
    from pfnl_tpu_torch.infer.predictor import MemoryFrames, Predictor
    from pfnl_tpu_torch.models.pfnl import PFNL
    from pfnl_tpu_torch.ops.cuda import KERNELS, launches, reset_launches

    model = PFNL(dtype=torch.bfloat16, generator=torch.Generator().manual_seed(SEED))
    model = model.cuda().eval()
    clip = synthetic_clip(CLIP_FRAMES, H * 4, W * 4, SEED)
    res = {}
    for key, devices in (("single", None), ("dp", [torch.device("cuda", 0)])):
        mem = MemoryFrames({f"clip/truth/{i:04d}.png": clip[i] for i in range(CLIP_FRAMES)})
        pred = Predictor(model, batch_windows=BATCH_WINDOWS, source=mem, sink=mem,
                         devices=devices)
        reset_launches()
        chunk_s = pred.test_video_truth("clip", name="sr")
        counts = {k: launches[k] for k in KERNELS}
        frames = [mem.read(p) for p in mem.list("clip/sr")]
        fps = (CLIP_FRAMES - BATCH_WINDOWS) / float(np.sum(chunk_s[1:]))
        res[key] = (counts, frames, fps)
    n_batches = -(-CLIP_FRAMES // BATCH_WINDOWS)
    same = (len(res["dp"][1]) == len(res["single"][1]) == CLIP_FRAMES
            and all(np.array_equal(a, b) for a, b in zip(res["dp"][1], res["single"][1])))
    want = {k: 0 for k in KERNELS}
    want.update(nonlocal_flash=n_batches, pfrb_a=20 * n_batches, pfrb_b=20 * n_batches,
                pfnl_tail=n_batches)
    print(f"[14a dp predictor] devices [cuda:0]: {CLIP_FRAMES} frames bitwise equal to the "
          f"single-device Predictor's: {same}; launches {res['dp'][0] == res['single'][0]} equal "
          f"({ {k: v for k, v in res['dp'][0].items() if v} }); delivered {res['dp'][2]:.2f} HR "
          f"frames/s (single {res['single'][2]:.2f}) on {card}", flush=True)
    if not same or res["dp"][0] != res["single"][0] or res["dp"][0] != want:
        fail("14a: the data-parallel Predictor differs from the single-device one")
    return res["dp"][0]


def _sp_attention(card):
    """14b: nonlocal_attention_sp over the world-1 NCCL group at phase 4's
    attention, [4,14400,84] bf16, against nonlocal_flash: bitwise, one K1."""
    from pfnl_tpu_torch.ops.cuda import KERNELS, launches, reset_launches
    from pfnl_tpu_torch.ops.cuda.nonlocal_flash import nonlocal_flash
    from pfnl_tpu_torch.parallel.nonlocal_sp import nonlocal_attention_sp

    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    shape = (BATCH_WINDOWS, (H // 2) * (W // 2), 3 * T * 4)
    th, ph = (_rand(shape, gen, dist="uniform").bfloat16() for _ in range(2))
    g = _rand(shape, gen, 0.5).bfloat16()
    with torch.inference_mode():
        reset_launches()
        got = nonlocal_attention_sp(th, ph, g)
        torch.cuda.synchronize()
        counts = {k: launches[k] for k in KERNELS}
        ref = nonlocal_flash(th, ph, g)
        sp_ms = cuda_time_ms(lambda: nonlocal_attention_sp(th, ph, g))
        k_ms = cuda_time_ms(lambda: nonlocal_flash(th, ph, g))
    same = torch.equal(got, ref)
    print(f"[14b sp attention] world-1 NCCL group, {list(shape)} bf16: bitwise equal to "
          f"nonlocal_flash: {same}; launches { {k: v for k, v in counts.items() if v} }; "
          f"{sp_ms:.3f} ms (nonlocal_flash {k_ms:.3f}) on {card}", flush=True)
    want = {k: int(k == "nonlocal_flash") for k in KERNELS}
    if not same or counts != want:
        fail("14b: nonlocal_attention_sp differs from kernel 1")
    return counts


def _params(model):
    return {k: p.detach().clone() for k, p in model.named_parameters()}


def _max_param_diff(a, b):
    return max((a[k] - b[k]).abs().max().item() for k in b)


def _ddp_world_1(card, rate_5c):
    """14c: Trainer.fit under DDP over the world-1 NCCL group at phase 5c's
    configuration: one step from the same weights and batch against the
    plain Trainer's (DDP1_TOL), then FIT_STEPS steps after FIT_WARM on both,
    steps/s and peak memory beside phase 5c's rate."""
    from pfnl_tpu_torch.ops.cuda import KERNELS, launches, reset_launches
    from pfnl_tpu_torch.parallel.mesh import make_mesh
    from pfnl_tpu_torch.train.trainer import Trainer

    cfg, seqs, mem = paper_train_set()
    mesh = make_mesh(1, 1)
    pipe = paper_pipeline(cfg, seqs, mem)
    try:
        batch = pipe.get_batch()
    finally:
        pipe.close()
    after = {}
    for ddp in (False, True):
        tr = Trainer(cfg, model=paper_model(SEED), device="cuda")
        if ddp:
            tr.distribute(mesh)
        tr.step(batch, tr.step_generator(0))
        after[ddp] = _params(tr.model)
    diff = _max_param_diff(after[True], after[False])
    out = {}
    for ddp in (True, False):
        tr = Trainer(cfg, model=paper_model(SEED), device="cuda")
        pipe = paper_pipeline(cfg, seqs, mem)
        log = []
        try:
            tr.fit(pipe, max_steps=FIT_WARM, save_every=10**9, log_every=10**9,
                   mesh=mesh if ddp else None, print_fn=log.append)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            t0 = time.perf_counter()
            tr.fit(pipe, max_steps=FIT_WARM + FIT_STEPS, save_every=10**9, log_every=5,
                   print_fn=log.append)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            pipe.close()
        losses = [float(line.rsplit("loss:", 1)[1]) for line in log if "loss:" in line]
        out[ddp] = dict(rate=FIT_STEPS / wall, peak=torch.cuda.max_memory_allocated(),
                        counts={k: launches[k] for k in KERNELS}, losses=losses)
        del tr
        torch.cuda.empty_cache()
    d, p = out[True], out[False]
    print(f"[14c ddp world 1] one step, DDP vs the plain Trainer: max |dp| {diff:.3e} (tolerance "
          f"{DDP1_TOL:.0e}); Trainer.fit {FIT_STEPS} steps after {FIT_WARM}: DDP {d['rate']:.3f} "
          f"steps/s, without {p['rate']:.3f} (phase 5c {rate_5c:.3f}), DDP / without "
          f"{d['rate'] / p['rate']:.3f}; peak memory DDP {d['peak'] / 2**30:.2f} GiB, without "
          f"{p['peak'] / 2**30:.2f} GiB; launches a step "
          f"{ {k: v / FIT_STEPS for k, v in d['counts'].items() if v} }; losses {d['losses']} "
          f"on {card}", flush=True)
    want = {k: 0 for k in KERNELS}
    want.update(pfrb_a=20, pfrb_b=20, pfnl_tail=1, pfrb_bwd_b=20, pfrb_bwd_a=20)
    if diff > DDP1_TOL or not d["losses"] or not all(np.isfinite(d["losses"])):
        fail("14c: the world-1 DDP step differs from the plain Trainer's")
    if any(d["counts"][k] != want[k] * FIT_STEPS for k in KERNELS):
        fail(f"14c: launches {d['counts']} != {want} x {FIT_STEPS}")
    return d["counts"]


def _ddp_rank(rank, port, directory):
    """14d, one of two ranks on cuda:0 over gloo: one DDP step of the
    paper-config PFNL on this rank's 8 rows of the batch."""
    from pfnl_tpu_torch.config import preset
    from pfnl_tpu_torch.ops.cuda import KERNELS, launches, reset_launches
    from pfnl_tpu_torch.parallel import multihost
    from pfnl_tpu_torch.parallel.mesh import make_mesh
    from pfnl_tpu_torch.train.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    multihost.initialize(f"localhost:{port}", 2, rank, device="cuda:0", backend="gloo")
    try:
        batch = torch.load(f"{directory}/batch.pt")
        rows = {k: v[rank * (len(v) // 2):(rank + 1) * (len(v) // 2)] for k, v in batch.items()}
        tr = Trainer(preset("pfnl", reload=False), model=paper_model(SEED), device="cuda:0")
        tr.distribute(make_mesh(2, 1))
        reset_launches()
        loss = tr.step(rows, tr.step_generator(0))["loss"]
        torch.cuda.synchronize()
        torch.save({"params": {k: v.cpu() for k, v in _params(tr.model).items()},
                    "loss": tr._mean_over_data(loss),
                    "launches": {k: launches[k] for k in KERNELS}},
                   f"{directory}/rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def _ddp_two_ranks(card):
    """14d: two processes on the one GPU over gloo, one DDP step each at the
    paper config with the global batch of 16 (8 rows a rank), through
    K2-K6, against one process's step at batch 16 (DDP2_TOL)."""
    import os

    import torch.multiprocessing as mp

    from pfnl_tpu_torch.train.trainer import Trainer

    cfg, seqs, mem = paper_train_set()
    pipe = paper_pipeline(cfg, seqs, mem)
    try:
        batch = {k: torch.as_tensor(v) for k, v in pipe.get_batch().items()}
    finally:
        pipe.close()
    directory = "pfnl_tpu_torch/build/smoke_ddp"
    os.makedirs(directory, exist_ok=True)
    torch.save(batch, f"{directory}/batch.pt")
    tr = Trainer(cfg, model=paper_model(SEED), device="cuda")
    loss = tr.step(batch, tr.step_generator(0))["loss"].item()
    want = {k: v.cpu() for k, v in _params(tr.model).items()}
    del tr
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    mp.spawn(_ddp_rank, args=(_free_port(), directory), nprocs=2, join=True)
    wall = time.perf_counter() - t0
    ranks = [torch.load(f"{directory}/rank{r}.pt") for r in range(2)]
    diffs = [_max_param_diff(r["params"], want) for r in ranks]
    print(f"[14d ddp 2 ranks, gloo, one GPU] batch {cfg.batch_size} as 2 x "
          f"{cfg.batch_size // 2}: max |dp| against one process {diffs} (tolerance "
          f"{DDP2_TOL:.0e}); loss {[r['loss'] for r in ranks]} vs {loss}; launches a rank "
          f"{[{k: v for k, v in r['launches'].items() if v} for r in ranks]}; {wall:.1f} s "
          f"with the processes' start on {card}", flush=True)
    for r in ranks:
        if not all(r["launches"][k] for k in PFNL_KERNELS[1:]):
            fail(f"14d: a rank did not run kernels 2-6: {r['launches']}")
    if max(diffs) > DDP2_TOL or any(abs(r["loss"] - loss) > 1e-5 * abs(loss) for r in ranks):
        fail("14d: two gloo ranks differ from one process at the global batch")


def phase_multi_gpu(card, rate_5c):
    """14: the data-parallel Predictor (a), spatial attention (b) and DDP
    (c) over a world-1 NCCL group on the one GPU, then two gloo ranks on it
    (d).  Returns the launches of a, b and c."""
    from pfnl_tpu_torch.ops.cuda import KERNELS
    from pfnl_tpu_torch.parallel import multihost

    multihost.initialize(f"localhost:{_free_port()}", 1, 0, device="cuda")
    try:
        parts = [_dp_predictor(card), _sp_attention(card), _ddp_world_1(card, rate_5c)]
    finally:
        torch.distributed.destroy_process_group()
    _ddp_two_ranks(card)
    return {k: sum(p[k] for p in parts) for k in KERNELS}


def main():
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke runs only on a CUDA GPU")
    import pfnl_tpu_torch  # noqa: F401  (fails here outside a checkout of the repo)

    # the plain side of every float32 comparison runs in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    name, count, smi = phase_device()
    phase_build()
    results = phase_kernels(name)
    results.update(phase_splat_kernels(name))
    counts = phase_end_to_end(name)
    results.update(phase_bwd_kernels(name))
    phase_train_gradients(name)
    train = phase_train_fit(name)
    train_counts = train["counts"]
    lr_frames, lrs = degraded_clip()
    y_counts = phase_y_serving(name, lr_frames, lrs)
    results.update(phase_duf_kernels(name))
    duf_counts, duf_model, window, ref = phase_duf_serving(name, lr_frames, lrs)
    pallas_counts = phase_duf_pallas(name, duf_model, window, ref)
    del duf_model, window, ref
    torch.cuda.empty_cache()
    frvsr_counts = phase_frvsr_serving(smi, lr_frames, lrs)
    flow_counts = phase_flow_training(smi)
    eval_counts = phase_eval(smi)
    duf_train_counts = phase_duf_training(smi)
    easyflow_counts = phase_easyflow_flownet(smi)
    export_counts = phase_export(smi, lrs)
    multi_counts = phase_multi_gpu(smi, train["steps_per_s"])

    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "flax", "pfnl_tpu"))
    if leaked:
        fail(f"the port loaded JAX-side modules: {leaked[:5]}")

    path_launches = {k: counts[k] + train_counts[k] + y_counts[k] + frvsr_counts[k]
                     + flow_counts[k] + eval_counts[k] + easyflow_counts[k] + export_counts[k]
                     + multi_counts[k] for k in TPU_KERNEL}
    path_launches.update(duf_block=duf_counts["duf_block"] + eval_counts["duf_block"]
                         + duf_train_counts["duf_block"] + export_counts["duf_block"],
                         duf_dense=pallas_counts["duf_dense"] + duf_train_counts["duf_dense"])
    kernels = [dict(name=k, route="cuda", source=SOURCE[k], replaces=TPU_KERNEL[k],
                    launches=path_launches[k], **{f: results[k][f] for f in (
                        "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
                    timed=TIMED[k])
               for k in TPU_KERNEL]
    if not all(kern["launches"] for kern in kernels):
        fail(f"a kernel was not launched on its path: {path_launches}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
