"""Kernel 10: DUF's 3x3x3 dense-block conv (csrc/duf_dense.cu).

Counterpart of `_conv3x3x3_tap_fwd_impl` (body `_kernel`) in
pfnl_tpu/ops/pallas/duf_dense.py; the plain version is `conv3x3x3_ref`
(ops/duf_ref.py).  bf16 runs the tensor-core tile of
csrc/duf_conv_mma.cuh (weights as bf16 [3,3,3,F,G]), which kernels 4 and 9
share; float32 the CUDA-core tile of csrc/duf_conv.cuh (weights as
float32).  `conv3x3x3` is the
autograd-aware entry the model calls (`Conv3x3x3`: the kernel forward,
and for the backward the plain conv's vector-Jacobian product, as JAX's
custom VJP recomputes XLA's).
"""

import torch

from pfnl_tpu_torch.ops.cuda import _build
from pfnl_tpu_torch.ops.cuda.duf_block import GROWTHS
from pfnl_tpu_torch.ops.duf_ref import conv3x3x3_ref


def duf_dense(x: torch.Tensor, wk: torch.Tensor, pad_t: bool) -> torch.Tensor:
    """x [B,T,H,W,F], wk [3,3,3,F,G] -> [B,T_out,H,W,G]: SAME in H/W, SAME
    (pad_t) or VALID in T, no bias."""
    if x.device.type == "cpu":
        return conv3x3x3_ref(x, wk, pad_t)
    _build.check_cuda_inputs("duf_dense", x)
    _build.check_no_grad("duf_dense", x, wk)
    if x.dim() != 5:
        raise ValueError(f"duf_dense: x must be [B,T,H,W,F], got {tuple(x.shape)}")
    nb, t, h, w, f = x.shape
    g = wk.shape[-1]
    if tuple(wk.shape) != (3, 3, 3, f, g) or g not in GROWTHS:
        raise ValueError(f"duf_dense: W {tuple(wk.shape)} does not fit x {tuple(x.shape)} "
                         f"(G in {GROWTHS})")
    t_out = t if pad_t else t - 2
    if t_out < 1:
        raise ValueError(f"duf_dense: {t} frames are too few for a VALID-T conv")
    _build.suffix(x.dtype)  # raises for a dtype the kernel does not take
    return torch.ops.pfnl.duf_dense(x, _build.kernel_weight(wk, x.dtype, x.device), bool(pad_t))


class Conv3x3x3(torch.autograd.Function):
    """Kernel 10 forward; the backward recomputes the plain conv and takes
    its vector-Jacobian product (JAX: `_make_tap`'s `bwd`)."""

    @staticmethod
    def forward(ctx, x, wk, pad_t):
        ctx.save_for_backward(x, wk)
        ctx.pad_t = pad_t
        return duf_dense(x, wk, pad_t)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        inputs = [v.detach().requires_grad_() for v in ctx.saved_tensors]
        with torch.enable_grad():
            out = conv3x3x3_ref(*inputs, ctx.pad_t)
        return (*torch.autograd.grad(out, inputs, g), None)


def conv3x3x3(x: torch.Tensor, wk: torch.Tensor, pad_t: bool) -> torch.Tensor:
    """The conv as the model calls it: `duf_dense`, through Conv3x3x3 when
    a gradient is wanted."""
    if torch.is_grad_enabled() and (x.requires_grad or wk.requires_grad):
        return Conv3x3x3.apply(x, wk, pad_t)
    return duf_dense(x, wk, pad_t)
