"""pfnl_tpu_torch — the PyTorch/CUDA port of pfnl_tpu, for NVIDIA Hopper.

The package sits beside the JAX package `pfnl_tpu`, which stays the
reference it is tested against, and mirrors its layout:

  config.py  Config and the reference's presets (a copy of pfnl_tpu.config)
  ops/       tensor ops (shuffle, resize, degrade, colour, TF-SAME convs,
             non-local attention, losses, warps, the ConvLSTM cell), the
             plain PyTorch versions of the PFRB chain, its backward, the
             merge tail and the two splats, and the chain under autograd
  ops/cuda/  wrappers of the hand-written CUDA kernels (sources in csrc/),
             built with nvcc on first use into build/
  models/    PFNL and the Y-channel flow families (VESPCN, MCResNet,
             LTDVSR, DRVSR) with their flow nets, as nn.Modules
  utils/     the flax-params <-> state_dict weight bridge
  data/      manifests, frame stores, the training input pipeline
  train/     losses and the Trainer
  eval/      periodic validation (PSNR)
  infer/     the testvideos() inference API, PFNL and the Y families

It imports torch and never jax, and loads nothing of `pfnl_tpu` (PNG
frames go through `pfnl_tpu.utils.image_io`, jax-free, on first use).
Activations keep the JAX package's channels-last layouts ([N,T,H,W,C],
[B,N,D]) at public functions, and conv kernels keep flax's HWIO layout, so
the two packages compare like with like.
"""

from pfnl_tpu_torch.config import Config, preset

__version__ = "0.1.0"

__all__ = ["Config", "preset"]
