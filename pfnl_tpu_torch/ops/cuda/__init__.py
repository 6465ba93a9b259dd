"""Wrappers of the port's hand-written CUDA kernels.

Each wrapper runs its plain PyTorch version on a CPU tensor and launches
its kernel on a CUDA tensor (or raises); there is no fallback from one to
the other.  `launches` counts kernel launches by name:

  nonlocal_flash  kernel 1  ops/cuda/nonlocal_flash.py  csrc/nonlocal_flash.cu
  pfrb_a          kernel 2  ops/cuda/pfrb.py            csrc/pfrb.cu
  pfrb_b          kernel 3  ops/cuda/pfrb.py            csrc/pfrb.cu
  pfnl_tail       kernel 4  ops/cuda/pfnl_tail.py       csrc/pfnl_tail.cu
"""

from pfnl_tpu_torch.ops.cuda._build import launches, reset_launches

KERNELS = ("nonlocal_flash", "pfrb_a", "pfrb_b", "pfnl_tail")

__all__ = ["KERNELS", "launches", "reset_launches"]
