"""Kernel 9: one DUF dense block on the persistent buffer (csrc/duf_block.cu).

Counterpart of `_run_block` (body `_kernel`) in
pfnl_tpu/ops/pallas/duf_block.py, driven by `dense_backbone` as
`dense_backbone_fused` drives it there; the plain versions are
`dense_block_ref` and `dense_backbone_ref` (ops/duf_ref.py).  The buffer is
a contiguous channels-last [B,T,H,W,C_fin] tensor with no pad stored; a
block writes its G new channels into it in place, which saves the copy of
the whole buffer that a functional update would take.  Inference only.
bf16 runs the tensor-core kernels (Wa and Wb handed over as bf16, rounded
once here), float32 the CUDA-core ones (weights as float32).
"""

import torch

from pfnl_tpu_torch.ops.cuda import _build
from pfnl_tpu_torch.ops.duf_ref import (BlockParams, backbone_loop, block_out_planes,
                                        dense_backbone_ref, dense_block_ref)

GROWTHS = (16, 32)  # the G the growth-conv tiles (duf_conv.cuh, duf_conv_mma.cuh) are built for


def dense_block(buf: torch.Tensor, p: BlockParams, in_lo: int, in_hi: int,
                scratch: torch.Tensor = None) -> torch.Tensor:
    """One block on buf [B,T,H,W,C], in place (see ops/duf_ref.py): reads
    channels [0, F) of the planes [in_lo, in_hi), writes channels [F, F+G)
    of the block's output planes, and returns buf.  scratch: a contiguous
    tensor of buf's dtype with at least B*(in_hi-in_lo)*H*W*F elements for
    the activation `a` (allocated when None)."""
    if buf.device.type == "cpu":
        return dense_block_ref(buf, p, in_lo, in_hi)
    _build.check_no_grad("duf_block", buf, *p[:7])
    if buf.dim() != 5:
        raise ValueError(f"duf_block: buf must be [B,T,H,W,C], got {tuple(buf.shape)}")
    nb, t, h, w, c = buf.shape
    f, g = p.wa.shape[0], p.wb.shape[-1]
    if tuple(p.wa.shape) != (f, f) or tuple(p.wb.shape) != (3, 3, 3, f, g):
        raise ValueError(f"duf_block: Wa {tuple(p.wa.shape)} / Wb {tuple(p.wb.shape)} do not fit")
    if g not in GROWTHS or f + g > c:
        raise ValueError(f"duf_block: growth {g} (kernels: {GROWTHS}) at F={f} in a buffer of "
                         f"{c} channels")
    out_lo, out_hi = block_out_planes(p.mode, in_lo, in_hi)
    if not 0 <= in_lo < in_hi <= t or out_lo >= out_hi:
        raise ValueError(f"duf_block: planes [{in_lo}, {in_hi}) of {t} for a {p.mode!r} block")
    need = nb * (in_hi - in_lo) * h * w * f
    if scratch is None:
        scratch = torch.empty(need, dtype=buf.dtype, device=buf.device)
    elif scratch.dtype != buf.dtype or scratch.numel() < need:
        raise ValueError(f"duf_block: scratch must hold {need} elements of {buf.dtype}")
    _build.check_cuda_inputs("duf_block", buf, scratch)
    dt, dev = buf.dtype, buf.device
    _build.suffix(dt)  # raises for a dtype the kernel does not take
    sa, oa, sb, ob, bb = (v.detach().to(device=dev, dtype=torch.float32).contiguous()
                          for v in (p.sa, p.oa, p.sb, p.ob, p.bb))
    wa, wb = (_build.kernel_weight(v, dt, dev) for v in (p.wa, p.wb))
    torch.ops.pfnl.duf_block(buf, scratch, sa, oa, wa, sb, ob, wb, bb, in_lo, in_hi,
                             p.mode == "thw")
    return buf


def dense_backbone(x64: torch.Tensor, blocks) -> torch.Tensor:
    """x64: conv1's output [B,T,H,W,C0].  Every dense block through
    `dense_block`, one scratch for all of them; returns the final features
    [B,T_fin,H,W,C_fin] (JAX: dense_backbone_fused)."""
    if x64.device.type == "cpu":
        return dense_backbone_ref(x64, blocks)
    nb, t, h, w, _ = x64.shape
    fmax = max(p.wa.shape[0] for p in blocks)
    scratch = torch.empty(nb * t * h * w * fmax, dtype=x64.dtype, device=x64.device)
    return backbone_loop(x64, blocks,
                         lambda buf, p, lo, hi: dense_block(buf, p, lo, hi, scratch))
