"""pfnl_tpu_torch — the PyTorch/CUDA port of pfnl_tpu, for NVIDIA Hopper.

The package sits beside the JAX package `pfnl_tpu`, which stays the
reference it is tested against, and mirrors its layout:

  config.py  Config and the reference's presets (a copy of pfnl_tpu.config)
  ops/       tensor ops (shuffle, resize, degrade, colour, TF-SAME convs,
             non-local attention, losses, warps, the ConvLSTM cell), the
             plain PyTorch versions of the PFRB chain, its backward, the
             merge tail and the two splats with their gather adjoints, and
             the chain and the splats under autograd
  ops/cuda/  wrappers of the hand-written CUDA kernels (sources in csrc/),
             built with nvcc on first use into build/, each launch a
             `torch.ops.pfnl` custom op (registered on import)
  models/    PFNL, the Y-channel flow families (VESPCN, MCResNet, LTDVSR,
             DRVSR) with their flow nets, FRVSR and DUF, as nn.Modules
  utils/     the flax-params <-> state_dict weight bridge, PNG I/O, the
             TF1 checkpoint reader and the seven families' importers, the
             host spans a torch.profiler trace records (spans.py)
  data/      manifests, frame stores, the training input pipeline, the
             blur{scale}/ renderer and filelists (prepare)
  train/     the losses and the Trainer of every family but DUF (staged
             optimisation, DRVSR's LSTM clip)
  eval/      periodic validation of every family (PSNR; SSIM on the card
             for the Y families), the MATLAB-equivalent Y-PSNR/SSIM
             metrics and parity tables
  infer/     the testvideos() inference API: window batches (on one device
             or data-parallel over several), and FRVSR's frame-by-frame
             recurrence; AOT export of a serving program (torch.export)
  parallel/  process groups, the (data, space) mesh, data-parallel serving
             and training helpers, spatially sharded non-local attention

It imports torch and never jax, and loads nothing of `pfnl_tpu`: what it
needs of a numpy-only module there, it carries as its own copy.
Activations keep the JAX package's channels-last layouts ([N,T,H,W,C],
[B,N,D]) at public functions, and conv kernels keep flax's HWIO layout, so
the two packages compare like with like.
"""

from pfnl_tpu_torch.config import Config, preset
from pfnl_tpu_torch.ops import cuda as _cuda  # noqa: F401  (registers the torch.ops.pfnl kernels)

__version__ = "0.1.0"

__all__ = ["Config", "preset"]
