"""Kernel 8: the SPMC upscale-while-warp splat (csrc/spmc_splat.cu).

Counterpart of `spmc_phases` in pfnl_tpu/ops/pallas/spmc_splat.py plus
the phase interleave and border fold that pfnl_tpu/ops/warp.py applies to
its canvases; the plain version is `forward_warp_local_spmc`
(ops/warp.py).  The public entry is `ops.warp.forward_warp_spmc`, which
trains through `SpmcSplat`: the kernel forward, the plain gather adjoint
`warp.spmc_splat_adjoint` backward (XLA in the JAX package too).
"""

import torch

from pfnl_tpu_torch.ops import warp
from pfnl_tpu_torch.ops.cuda import _build

SCALE = 4  # the kernel's HR tile is compiled for x4 (DRVSR's only scale)


def spmc_splat(im: torch.Tensor, uv: torch.Tensor, scale: int, max_disp: int) -> torch.Tensor:
    """im [B,H,W,1], uv [B,H,W,2] with |uv| <= max_disp -> the splat onto
    the x`scale` grid, [B,sH,sW,1] in im's dtype, border folded.  On a
    CUDA tensor max_disp is at most _build.splat_max_disp(); the plain
    version takes any."""
    if im.device.type == "cpu":
        return warp.forward_warp_local_spmc(im, uv, scale, max_disp)
    _build.check_cuda_inputs("spmc_splat", im, uv)
    _build.check_no_grad("spmc_splat", im, uv)
    if im.dtype != uv.dtype:
        raise TypeError(f"spmc_splat: im {im.dtype} and uv {uv.dtype} differ")
    _build.suffix(im.dtype)  # raises for a dtype the kernel does not take
    if im.dim() != 4 or im.shape[-1] != 1 or tuple(uv.shape) != tuple(im.shape[:3]) + (2,):
        raise ValueError(f"spmc_splat: im must be [B,H,W,1] and uv [B,H,W,2], got "
                         f"{tuple(im.shape)} and {tuple(uv.shape)}")
    b, h, w, _ = im.shape
    bound = _build.splat_max_disp()
    if scale != SCALE or not 0 <= max_disp <= bound or min(b, h, w) < 1:
        raise ValueError(f"spmc_splat: takes scale {SCALE} and 0 <= max_disp <= {bound}, "
                         f"got scale={scale}, max_disp={max_disp}")
    return torch.ops.pfnl.spmc_splat(im, uv, int(scale), int(max_disp))


class SpmcSplat(torch.autograd.Function):
    """Kernel 8 under autograd: the forward launches the kernel (grad is off
    inside a Function's forward), the backward is the gather adjoint."""

    @staticmethod
    def forward(ctx, im, uv, scale: int, max_disp: int):
        ctx.scale, ctx.max_disp = scale, max_disp
        ctx.save_for_backward(im, uv)
        return spmc_splat(im, uv, scale, max_disp)

    @staticmethod
    def backward(ctx, g):
        im, uv = ctx.saved_tensors
        d_im, d_uv = warp.spmc_splat_adjoint(im, uv, g, ctx.scale, ctx.max_disp)
        return d_im, d_uv, None, None
