"""Wrappers of the port's hand-written CUDA kernels.

Each wrapper runs its plain PyTorch version on a CPU tensor and launches
its kernel on a CUDA tensor (or raises); there is no fallback from one to
the other.  On a CUDA tensor the wrapper checks the inputs, casts the
weights and calls its `torch.library` custom op, `torch.ops.pfnl.<name>`
(library.py, registered when this package is imported; nothing is built
until the first launch), so `torch.export` traces each launch as one node
(infer/export.py).  A kernel records no autograd graph, so on a CUDA
tensor a wrapper raises when grad is enabled and an input requires it;
training reaches kernels 2-6 through ops/pfrb_chain.py and `merge_tail`,
kernels 7 and 8 through `BoundedSplat` / `SpmcSplat` (ops/warp.py routes
to them), kernel 10 through `conv3x3x3`.  `launches` counts the op calls
that launch a kernel, by name, where the op's CUDA kernel launches it (so a
launch from a loaded artifact counts, and tracing counts none; kernels 4
and 9 are two launches from one call, counted once).  `entries` counts the
same launches by the C entry they called, which tells apart the two bf16
bodies of kernels 2 and 3 (`pfnl_pfrb_a_bf16_wgmma`, or `pfnl_pfrb_a_bf16`
for views a tensor map cannot describe):

  nonlocal_flash  kernel 1   ops/cuda/nonlocal_flash.py  csrc/nonlocal_flash.cu, mma.cuh
  pfrb_a          kernel 2   ops/cuda/pfrb.py            csrc/pfrb.cu, wgmma.cuh (bf16), tf32_conv.cuh
                                                         (float32)
  pfrb_b          kernel 3   ops/cuda/pfrb.py            csrc/pfrb.cu, as kernel 2
  pfnl_tail       kernel 4   ops/cuda/pfnl_tail.py       csrc/pfnl_tail.cu, duf_conv_mma.cuh
  pfrb_bwd_b      kernel 5   ops/cuda/pfrb_bwd.py        csrc/pfrb_bwd.cu, tf32_conv.cuh (float32)
  pfrb_bwd_a      kernel 6   ops/cuda/pfrb_bwd.py        csrc/pfrb_bwd.cu, as kernel 5
  bounded_splat   kernel 7   ops/cuda/bounded_splat.py   csrc/bounded_splat.cu
  spmc_splat      kernel 8   ops/cuda/spmc_splat.py      csrc/spmc_splat.cu
  duf_block       kernel 9   ops/cuda/duf_block.py       csrc/duf_block.cu, duf_conv_mma.cuh
                                                         (bf16), duf_conv.cuh (float32)
  duf_dense       kernel 10  ops/cuda/duf_dense.py       csrc/duf_dense.cu, as kernel 9

The bf16 entries of kernels 1-4, 9 and 10 run on the tensor cores (1-3
on Hopper's wgmma warpgroups, csrc/wgmma.cuh, 2-3 fed by tensor-map copies;
4, 9 and 10 on mma.sync, the implicit-GEMM tile of duf_conv_mma.cuh), and
so do the float32 entries of kernels 2, 3, 5 and 6 (3xTF32, on the tile of
tf32_conv.cuh); kernels 7 and 8, the bf16 entries of 5 and 6 and the
float32 entries of 1, 4, 9 and 10 run on CUDA cores.

Kernels 1-6 serve PFNL; 7 and 8 the flow families, reached through
ops/warp.py's `forward_warp_local` and `forward_warp_spmc`; 9 and 10 DUF's
dense blocks (models/duf.py: 9 for the whole backbone, 10 per growth conv
with conv3d_impl="pallas").
"""

from pfnl_tpu_torch.ops.cuda import library  # noqa: F401  (registers torch.ops.pfnl)
from pfnl_tpu_torch.ops.cuda._build import entries, launches, reset_launches

KERNELS = ("nonlocal_flash", "pfrb_a", "pfrb_b", "pfnl_tail", "pfrb_bwd_b", "pfrb_bwd_a",
           "bounded_splat", "spmc_splat", "duf_block", "duf_dense")

__all__ = ["KERNELS", "entries", "launches", "reset_launches"]
