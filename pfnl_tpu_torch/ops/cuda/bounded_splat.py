"""Kernel 7: the bounded same-size bilinear splat (csrc/bounded_splat.cu).

Counterpart of `bounded_splat_canvas` in
pfnl_tpu/ops/pallas/bounded_splat.py plus the border fold that
pfnl_tpu/ops/warp.py applies to its canvas; the plain version is
`forward_warp_local_ref` (ops/warp.py).  The public entry is
`ops.warp.forward_warp_local`, which trains through `BoundedSplat`: the
kernel forward, the plain gather adjoint `warp.bounded_splat_adjoint`
backward (the JAX package's adjoint is XLA too, no Pallas kernel).
"""

import torch

from pfnl_tpu_torch.ops import warp
from pfnl_tpu_torch.ops.cuda import _build

MAX_CHANNELS = 4  # channels a pixel of the kernel's shared-memory tile holds


def bounded_splat(im: torch.Tensor, uv: torch.Tensor, max_disp: int) -> torch.Tensor:
    """im [B,H,W,C], uv [B,H,W,2] with |uv| <= max_disp -> the splat
    [B,H,W,C] in im's dtype, border folded.  Taps outside the window of
    the bound are dropped, as in the plain version.  On a CUDA tensor
    max_disp is at most _build.splat_max_disp(); the plain version takes any."""
    if im.device.type == "cpu":
        return warp.forward_warp_local_ref(im, uv, max_disp)
    _build.check_cuda_inputs("bounded_splat", im, uv)
    _build.check_no_grad("bounded_splat", im, uv)
    if im.dtype != uv.dtype:
        raise TypeError(f"bounded_splat: im {im.dtype} and uv {uv.dtype} differ")
    _build.suffix(im.dtype)  # raises for a dtype the kernel does not take
    if im.dim() != 4 or tuple(uv.shape) != tuple(im.shape[:3]) + (2,):
        raise ValueError(f"bounded_splat: im must be [B,H,W,C] and uv [B,H,W,2], got "
                         f"{tuple(im.shape)} and {tuple(uv.shape)}")
    b, h, w, c = im.shape
    bound = _build.splat_max_disp()
    if not 1 <= c <= MAX_CHANNELS or not 0 <= max_disp <= bound or min(b, h, w) < 1:
        raise ValueError(f"bounded_splat: takes 1 <= C <= {MAX_CHANNELS} and 0 <= max_disp <= "
                         f"{bound}, got C={c}, max_disp={max_disp}")
    return torch.ops.pfnl.bounded_splat(im, uv, int(max_disp))


class BoundedSplat(torch.autograd.Function):
    """Kernel 7 under autograd: the forward launches the kernel (grad is off
    inside a Function's forward), the backward is the gather adjoint."""

    @staticmethod
    def forward(ctx, im, uv, max_disp: int):
        ctx.max_disp = max_disp
        ctx.save_for_backward(im, uv)
        return bounded_splat(im, uv, max_disp)

    @staticmethod
    def backward(ctx, g):
        im, uv = ctx.saved_tensors
        d_im, d_uv = warp.bounded_splat_adjoint(im, uv, g, ctx.max_disp)
        return d_im, d_uv, None
