"""pfnl_tpu_torch — the PyTorch/CUDA port of pfnl_tpu, for NVIDIA Hopper.

The package sits beside the JAX package `pfnl_tpu`, which stays the
reference it is tested against, and mirrors its layout:

  ops/       tensor ops (shuffle, resize, degrade, non-local attention) and
             the plain PyTorch versions of the PFRB chain and merge tail
  ops/cuda/  wrappers of the hand-written CUDA kernels (sources in csrc/),
             built with nvcc on first use into build/
  models/    NonLocalBlock and PFNL as nn.Modules
  utils/     the flax-params <-> state_dict weight bridge
  data/      dataset-directory scanning
  infer/     the testvideos() inference API

It imports torch and never jax.  Activations keep the JAX package's
channels-last layouts ([N,T,H,W,C], [B,N,D]) at public functions, and conv
kernels keep flax's HWIO layout, so the two packages compare like with like.

`Config` and `preset` are the JAX package's own (`pfnl_tpu.config` is plain
dataclasses and imports no jax); they load on first access, so importing
this package loads nothing of `pfnl_tpu`.
"""

__version__ = "0.1.0"


def __getattr__(name):
    if name in ("Config", "preset"):
        from pfnl_tpu import config

        return getattr(config, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
