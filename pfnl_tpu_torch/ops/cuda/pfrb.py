"""Kernels 2 and 3: the two halves of a PFRB (csrc/pfrb.cu).

Counterparts of `_kernel_a` / `_kernel_b` in
pfnl_tpu/ops/pallas/pfrb_pack.py; the plain versions are `pfrb_a_ref` and
`pfrb_b_ref` (ops/pfrb_ref.py).  Activations are contiguous [N,T,H,W,64]
float32 or bfloat16; kernels are HWIO, as flax stores them.  Both run on
the tensor cores: bf16 as bf16 products (weights handed over as bf16,
rounded once here), float32 as 3xTF32 products, which hold float32's
accuracy (weights as float32); biases go as float32 rounded to the
activation type, as the plain versions cast them.  The bf16 op launches
one of two bodies (`entry`), and `_build.entries` counts which.
"""

import torch

from pfnl_tpu_torch.ops.cuda import _build
from pfnl_tpu_torch.ops.pfrb_ref import pfrb_a_ref, pfrb_b_ref

CHANNELS = 64


def aligned16(*tensors) -> bool:
    """Every tensor's data starts 16-byte aligned, as a tensor map needs."""
    return all(x.data_ptr() % 16 == 0 for x in tensors)


def entry(name: str, dtype: torch.dtype, aligned: bool) -> str:
    """The C entry that op `name` ("pfrb_a" or "pfrb_b") launches: in bf16,
    with every input 16-byte aligned, the body on the warpgroup tensor cores
    (tensor-map copies into a ring, wgmma warpgroups); in bf16 otherwise, the
    mma.sync body, for views a tensor map cannot describe; in float32, the
    3xTF32 body.  A pure function of what the op observes, so every caller
    adapts without a setting: the serving widths and the 32-wide training
    crop alike take the wgmma body, which measured faster at both (PERF.md,
    section 6)."""
    if dtype != torch.bfloat16:
        return f"pfnl_{name}_{_build.suffix(dtype)}"
    return f"pfnl_{name}_bf16_wgmma" if aligned else f"pfnl_{name}_bf16"


def _check_feat(name, feat):
    if feat.dim() != 5 or feat.shape[-1] != CHANNELS:
        raise ValueError(f"{name}: feat must be [N,T,H,W,{CHANNELS}], got {tuple(feat.shape)}")


def pfrb_a(feat, w1, b1, wfuse, bfuse):
    """Kernel A: feat [N,T,H,W,64] -> (i1 [N,T,H,W,64], base [N,H,W,64])."""
    if feat.device.type == "cpu":
        return pfrb_a_ref(feat, w1, b1, wfuse, bfuse)
    _build.check_cuda_inputs("pfrb_a", feat)
    _build.check_no_grad("pfrb_a", feat, w1, b1, wfuse, bfuse)
    _check_feat("pfrb_a", feat)
    n, t, h, w, c = feat.shape
    if tuple(w1.shape) != (3, 3, c, c) or tuple(wfuse.shape) != (t, c, c):
        raise ValueError(f"pfrb_a: W1 {tuple(w1.shape)} / Wfuse {tuple(wfuse.shape)} "
                         f"do not fit feat {tuple(feat.shape)}")
    _build.suffix(feat.dtype)  # raises for a dtype the kernel does not take
    w1f, wff = (_build.kernel_weight(p, feat.dtype, feat.device) for p in (w1, wfuse))
    b1f, bff = (_build.weight_f32(p, feat.dtype, feat.device) for p in (b1, bfuse))
    return torch.ops.pfnl.pfrb_a(feat, w1f, b1f, wff, bff)


def pfrb_b(feat, i1, base, w2f, w2b, b2):
    """Kernel B: -> out [N,T,H,W,64] = feat + lrelu(conv(i1,W2f) +
    conv(base,W2b) + b2), in a new buffer."""
    if feat.device.type == "cpu":
        return pfrb_b_ref(feat, i1, base, w2f, w2b, b2)
    _build.check_cuda_inputs("pfrb_b", feat, i1, base)
    _build.check_no_grad("pfrb_b", feat, i1, base, w2f, w2b, b2)
    _check_feat("pfrb_b", feat)
    n, t, h, w, c = feat.shape
    if i1.shape != feat.shape or tuple(base.shape) != (n, h, w, c):
        raise ValueError(f"pfrb_b: i1 {tuple(i1.shape)} / base {tuple(base.shape)} "
                         f"do not fit feat {tuple(feat.shape)}")
    if not feat.dtype == i1.dtype == base.dtype:
        raise TypeError("pfrb_b: feat, i1 and base must share a dtype")
    if tuple(w2f.shape) != (3, 3, c, c) or tuple(w2b.shape) != (3, 3, c, c):
        raise ValueError("pfrb_b: W2f and W2b must be [3,3,64,64]")
    _build.suffix(feat.dtype)  # raises for a dtype the kernel does not take
    w2ff, w2bf = (_build.kernel_weight(p, feat.dtype, feat.device) for p in (w2f, w2b))
    b2f = _build.weight_f32(b2, feat.dtype, feat.device)
    return torch.ops.pfnl.pfrb_b(feat, i1, base, w2ff, w2bf, b2f)


def pfrb_block(feat, w1, b1, wfuse, bfuse, w2f, w2b, b2):
    """One PFRB: kernel A then kernel B."""
    i1, base = pfrb_a(feat, w1, b1, wfuse, bfuse)
    return pfrb_b(feat, i1, base, w2f, w2b, b2)
