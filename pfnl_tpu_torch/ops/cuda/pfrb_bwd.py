"""Kernels 5 and 6: the backward of the two halves of a PFRB
(csrc/pfrb_bwd.cu).

Counterparts of `_kernel_bwd_b` / `_kernel_bwd_a` in
pfnl_tpu/ops/pallas/pfrb_bwd.py; the plain versions are `pfrb_bwd_b_ref`
and `pfrb_bwd_a_ref` (ops/pfrb_ref.py).  Activations and their
cotangents are contiguous [N,T,H,W,64] float32 or bfloat16; kernels are
HWIO.  Data gradients come out in the activation dtype, weight and bias
gradients in float32, summed in a fixed order (bitwise reproducible).
The float32 entries run on the tensor cores as 3xTF32 (each float32
product as three TF32 products of a hi + lo split); the bf16 entries run
float FMAs on CUDA cores.
"""

import torch

from pfnl_tpu_torch.ops.cuda import _build
from pfnl_tpu_torch.ops.cuda.pfrb import CHANNELS, _check_feat
from pfnl_tpu_torch.ops.pfrb_ref import mirror_t, pfrb_bwd_a_ref, pfrb_bwd_b_ref

_KERNEL_ENTRIES = 9 * CHANNELS * CHANNELS  # dW [3,3,64,64], then db [64]


def _split(buf):
    c = CHANNELS
    return buf[:_KERNEL_ENTRIES].view(3, 3, c, c), buf[_KERNEL_ENTRIES:]


def _conv_t_weight(w, dtype, device):
    """The transposed conv's kernel as the entry for `dtype` reads it, rounded
    to dtype and held as float32: [3,3,out,in] for the float32 (3xTF32)
    entries, which is w flipped in space; HWIO mirror_t(w) for bf16."""
    if dtype == torch.float32:
        return _build.weight_f32(w.flip(0, 1), dtype, device)
    return _build.weight_f32(mirror_t(w), dtype, device)


def _check_kernel(name, w, c):
    if tuple(w.shape) != (3, 3, c, c):
        raise ValueError(f"{name}: conv kernels must be [3,3,{c},{c}], got {tuple(w.shape)}")


def pfrb_bwd_b(dz2, i1, base, w2f, w2b):
    """Kernel 5: dz2 [N,T,H,W,64] -> (d_i1 [N,T,H,W,64], d_base [N,H,W,64],
    dW2f, dW2b [3,3,64,64] float32, db2 [64] float32)."""
    if dz2.device.type == "cpu":
        return pfrb_bwd_b_ref(dz2, i1, base, w2f, w2b)
    _build.check_cuda_inputs("pfrb_bwd_b", dz2, i1, base)
    _build.check_no_grad("pfrb_bwd_b", dz2, i1, base, w2f, w2b)
    _check_feat("pfrb_bwd_b", dz2)
    n, t, h, w, c = dz2.shape
    if i1.shape != dz2.shape or tuple(base.shape) != (n, h, w, c):
        raise ValueError(f"pfrb_bwd_b: i1 {tuple(i1.shape)} / base {tuple(base.shape)} "
                         f"do not fit dz2 {tuple(dz2.shape)}")
    if not dz2.dtype == i1.dtype == base.dtype:
        raise TypeError("pfrb_bwd_b: dz2, i1 and base must share a dtype")
    _check_kernel("pfrb_bwd_b", w2f, c)
    _check_kernel("pfrb_bwd_b", w2b, c)
    dt, dev = dz2.dtype, dz2.device
    _build.suffix(dt)  # raises for a dtype the kernel does not take
    w2ft, w2bt = (_conv_t_weight(p, dt, dev) for p in (w2f, w2b))
    d_i1, d_base, gw2f, gw2b = torch.ops.pfnl.pfrb_bwd_b(dz2, i1, base, w2ft, w2bt)
    dw2f, db2 = _split(gw2f)
    return d_i1, d_base, dw2f, _split(gw2b)[0], db2


def pfrb_bwd_a(dz1, feat, g, w1):
    """Kernel 6: dz1 [N,T,H,W,64] -> (d_feat = g + convT(dz1, W1)
    [N,T,H,W,64], dW1 [3,3,64,64] float32, db1 [64] float32)."""
    if dz1.device.type == "cpu":
        return pfrb_bwd_a_ref(dz1, feat, g, w1)
    _build.check_cuda_inputs("pfrb_bwd_a", dz1, feat, g)
    _build.check_no_grad("pfrb_bwd_a", dz1, feat, g, w1)
    _check_feat("pfrb_bwd_a", dz1)
    if feat.shape != dz1.shape or g.shape != dz1.shape:
        raise ValueError(f"pfrb_bwd_a: feat {tuple(feat.shape)} / g {tuple(g.shape)} "
                         f"do not fit dz1 {tuple(dz1.shape)}")
    if not dz1.dtype == feat.dtype == g.dtype:
        raise TypeError("pfrb_bwd_a: dz1, feat and g must share a dtype")
    n, t, h, w, c = dz1.shape
    _check_kernel("pfrb_bwd_a", w1, c)
    dt, dev = dz1.dtype, dz1.device
    _build.suffix(dt)  # raises for a dtype the kernel does not take
    d_feat, gw1 = torch.ops.pfnl.pfrb_bwd_a(dz1, feat, g, _conv_t_weight(w1, dt, dev))
    dw1, db1 = _split(gw1)
    return d_feat, dw1, db1
