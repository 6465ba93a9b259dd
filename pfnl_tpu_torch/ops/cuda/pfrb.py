"""Kernels 2 and 3: the two halves of a PFRB (csrc/pfrb.cu).

Counterparts of `_kernel_a` / `_kernel_b` in
pfnl_tpu/ops/pallas/pfrb_pack.py; the plain versions are `pfrb_a_ref` and
`pfrb_b_ref` (ops/pfrb_ref.py).  Activations are contiguous [N,T,H,W,64]
float32 or bfloat16; kernels are HWIO, as flax stores them.
"""

import torch

from pfnl_tpu_torch.ops.cuda import _build
from pfnl_tpu_torch.ops.pfrb_ref import pfrb_a_ref, pfrb_b_ref

CHANNELS = 64


def _check_feat(name, feat):
    if feat.dim() != 5 or feat.shape[-1] != CHANNELS:
        raise ValueError(f"{name}: feat must be [N,T,H,W,{CHANNELS}], got {tuple(feat.shape)}")


def pfrb_a(feat, w1, b1, wfuse, bfuse):
    """Kernel A: feat [N,T,H,W,64] -> (i1 [N,T,H,W,64], base [N,H,W,64])."""
    if feat.device.type == "cpu":
        return pfrb_a_ref(feat, w1, b1, wfuse, bfuse)
    _build.check_cuda_inputs("pfrb_a", feat)
    _check_feat("pfrb_a", feat)
    n, t, h, w, c = feat.shape
    if tuple(w1.shape) != (3, 3, c, c) or tuple(wfuse.shape) != (t, c, c):
        raise ValueError(f"pfrb_a: W1 {tuple(w1.shape)} / Wfuse {tuple(wfuse.shape)} "
                         f"do not fit feat {tuple(feat.shape)}")
    sfx = _build.suffix(feat.dtype)
    w1f, b1f, wff, bff = (_build.weight_f32(p, feat.dtype, feat.device)
                          for p in (w1, b1, wfuse, bfuse))
    i1 = torch.empty_like(feat)
    base = torch.empty(n, h, w, c, dtype=feat.dtype, device=feat.device)
    _build.call(f"pfnl_pfrb_a_{sfx}", feat, w1f, b1f, wff, bff, i1, base, n, t, h, w)
    _build.launches["pfrb_a"] += 1
    return i1, base


def pfrb_b(feat, i1, base, w2f, w2b, b2):
    """Kernel B: -> out [N,T,H,W,64] = feat + lrelu(conv(i1,W2f) +
    conv(base,W2b) + b2), in a new buffer."""
    if feat.device.type == "cpu":
        return pfrb_b_ref(feat, i1, base, w2f, w2b, b2)
    _build.check_cuda_inputs("pfrb_b", feat, i1, base)
    _check_feat("pfrb_b", feat)
    n, t, h, w, c = feat.shape
    if i1.shape != feat.shape or tuple(base.shape) != (n, h, w, c):
        raise ValueError(f"pfrb_b: i1 {tuple(i1.shape)} / base {tuple(base.shape)} "
                         f"do not fit feat {tuple(feat.shape)}")
    if not feat.dtype == i1.dtype == base.dtype:
        raise TypeError("pfrb_b: feat, i1 and base must share a dtype")
    if tuple(w2f.shape) != (3, 3, c, c) or tuple(w2b.shape) != (3, 3, c, c):
        raise ValueError("pfrb_b: W2f and W2b must be [3,3,64,64]")
    sfx = _build.suffix(feat.dtype)
    w2ff, w2bf, b2f = (_build.weight_f32(p, feat.dtype, feat.device) for p in (w2f, w2b, b2))
    out = torch.empty_like(feat)
    _build.call(f"pfnl_pfrb_b_{sfx}", feat, i1, base, w2ff, w2bf, b2f, out, n, t, h, w)
    _build.launches["pfrb_b"] += 1
    return out


def pfrb_block(feat, w1, b1, wfuse, bfuse, w2f, w2b, b2):
    """One PFRB: kernel A then kernel B."""
    i1, base = pfrb_a(feat, w1, b1, wfuse, bfuse)
    return pfrb_b(feat, i1, base, w2f, w2b, b2)
