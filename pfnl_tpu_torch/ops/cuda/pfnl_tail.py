"""Kernel 4: the PFNL merge tail on the LR grid (csrc/pfnl_tail.cu).

Counterpart of `pfnl_tail_pack` in pfnl_tpu/ops/pallas/pfnl_tail.py; the
plain version is `pfnl_tail_ref` (ops/pfrb_ref.py).  `compose_d2s4` and
the bicubic add stay in PyTorch.  `merge_tail` is the autograd-aware
entry the model calls (MergeTail: kernel forward, plain recompute
backward).  bf16 runs the tensor-core kernels (Wm1 and the folded Wm2
handed over as bf16, rounded once here), float32 the CUDA-core ones
(weights as float32); biases go as float32 rounded to the activation dtype.
"""

import torch

from pfnl_tpu_torch.ops.cuda import _build
from pfnl_tpu_torch.ops.pfrb_ref import fold_d2s_conv, pfnl_tail_ref

CHANNELS, MERGE = 64, 48


def pfnl_tail(feat5, wm1, bm1, km2, bm2):
    """feat5 [N,T,H,W,64] -> folded [N,H,W,48] (channel (pr*2+pc)*12+c12)."""
    if feat5.device.type == "cpu":
        return pfnl_tail_ref(feat5, wm1, bm1, km2, bm2)
    _build.check_cuda_inputs("pfnl_tail", feat5)
    _build.check_no_grad("pfnl_tail", feat5, wm1, bm1, km2, bm2)
    if feat5.dim() != 5 or feat5.shape[-1] != CHANNELS:
        raise ValueError(f"pfnl_tail: feat must be [N,T,H,W,{CHANNELS}], "
                         f"got {tuple(feat5.shape)}")
    n, t, h, w, c = feat5.shape
    if tuple(wm1.shape) != (3, 3, t * c, MERGE) or tuple(km2.shape) != (3, 3, 12, 12):
        raise ValueError(f"pfnl_tail: Wm1 {tuple(wm1.shape)} / Wm2 {tuple(km2.shape)} "
                         f"do not fit feat {tuple(feat5.shape)}")
    dt, dev = feat5.dtype, feat5.device
    _build.suffix(dt)  # raises for a dtype the kernel does not take
    wm1k = _build.kernel_weight(wm1, dt, dev)
    bm1f = _build.weight_f32(bm1, dt, dev)
    # the fold puts at most one HR tap in each LR entry, so folding after the
    # rounding is exact
    wf = fold_d2s_conv(_build.kernel_weight(km2, dt, dev)).contiguous()
    bf = _build.weight_f32(bm2, dt, dev).repeat(4).contiguous()
    return torch.ops.pfnl.pfnl_tail(feat5, wm1k, bm1f, wf, bf)


class MergeTail(torch.autograd.Function):
    """Kernel 4 forward; the backward recomputes the plain tail and takes
    its vjp.  Counterpart of `blocks_and_tail_pack`'s tail half
    (pfnl_tail.py `_bt_fwd` / `_bt_bwd`), which re-runs `_xla_tail_only`:
    the TPU package has no tail backward kernel either."""

    @staticmethod
    def forward(ctx, feat5, wm1, bm1, km2, bm2):
        ctx.save_for_backward(feat5, wm1, bm1, km2, bm2)
        return pfnl_tail(feat5, wm1, bm1, km2, bm2)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        inputs = [x.detach().requires_grad_() for x in ctx.saved_tensors]
        with torch.enable_grad():
            out = pfnl_tail_ref(*inputs)
        return torch.autograd.grad(out, inputs, g)


def merge_tail(feat5, wm1, bm1, km2, bm2):
    """The tail as PFNL calls it: `pfnl_tail`, through MergeTail when a
    gradient is wanted."""
    if torch.is_grad_enabled() and any(
            x.requires_grad for x in (feat5, wm1, bm1, km2, bm2)):
        return MergeTail.apply(feat5, wm1, bm1, km2, bm2)
    return pfnl_tail(feat5, wm1, bm1, km2, bm2)
