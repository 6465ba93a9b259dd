"""Plain PyTorch versions of the PFRB chain (kernels 2 and 3), of its
backward (kernels 5 and 6) and of the PFNL merge tail (kernel 4).
Counterparts: pfnl_tpu/ops/pallas/pfrb_xla.py, `_chain_manual_bwd` in
pfnl_tpu/ops/pallas/pfrb_pack.py, and `_xla_tail_only` / `compose_d2s4` /
`_fold_d2s_conv` in pfnl_tpu/ops/pallas/pfnl_tail.py.

One PFRB, per sample (T frames, C = 64 channels, HWIO kernels):

    i1_t  = lrelu(conv3x3(feat_t, W1) + b1)                     kernel A
    base  = lrelu(sum_t i1_t @ Wfuse_t + bfuse)                 kernel A
    out_t = feat_t + lrelu(conv3x3(i1_t, W2f)
                           + conv3x3(base, W2b) + b2)           kernel B

Weights are cast to the activation dtype at use, as the JAX package does.
"""

import numpy as np
import torch
import torch.nn.functional as F

from pfnl_tpu_torch.ops.constants import on_device
from pfnl_tpu_torch.ops.conv import conv2d_same
from pfnl_tpu_torch.ops.shuffle import depth_to_space


def leaky_relu(x, alpha: float = 0.2):
    """tf.nn.leaky_relu's default alpha 0.2, as max(x, alpha*x)."""
    return torch.maximum(x, alpha * x)


def pfrb_a_ref(feat, w1, b1, wfuse, bfuse):
    """feat [N,T,H,W,C] -> (i1 [N,T,H,W,C], base [N,H,W,C])."""
    n, t, h, w, c = feat.shape
    dt = feat.dtype
    i1 = leaky_relu(conv2d_same(feat.reshape(n * t, h, w, c), w1) + b1.to(dt))
    i1 = i1.reshape(n, t, h, w, c)
    base = leaky_relu(torch.einsum("nthwc,tcd->nhwd", i1, wfuse.to(dt)) + bfuse.to(dt))
    return i1.contiguous(), base.contiguous()


def pfrb_b_ref(feat, i1, base, w2f, w2b, b2):
    """-> out [N,T,H,W,C] = feat + lrelu(conv(i1,W2f) + conv(base,W2b) + b2)."""
    n, t, h, w, c = feat.shape
    base_part = conv2d_same(base, w2b)
    frame_part = conv2d_same(i1.reshape(n * t, h, w, c), w2f).reshape(n, t, h, w, c)
    i2 = leaky_relu(frame_part + base_part[:, None] + b2.to(feat.dtype))
    return (feat + i2).contiguous()


def pfrb_block_ref(feat, w1, b1, wfuse, bfuse, w2f, w2b, b2):
    i1, base = pfrb_a_ref(feat, w1, b1, wfuse, bfuse)
    return pfrb_b_ref(feat, i1, base, w2f, w2b, b2)


def pfrb_chain_ref(feat, params_list):
    for p in params_list:
        feat = pfrb_block_ref(feat, *p)
    return feat


def acc_dtype(x: torch.Tensor) -> torch.Tensor:
    """x widened to at least float32, the type sums and weight gradients
    accumulate in (float64 stays float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def mirror_t(k: torch.Tensor) -> torch.Tensor:
    """[3,3,Ci,Co] -> [3,3,Co,Ci]: the kernel whose SAME conv is the
    transposed conv of k (pfnl_tpu pfrb_bwd.py `mirror_t`)."""
    return k.flip(0, 1).transpose(2, 3)


def conv_w_grad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Weight gradient [3,3,Ci,Co] of a stride-1 SAME 3x3 conv from its
    input x [B,H,W,Ci] and output cotangent dy [B,H,W,Co], accumulated in
    float32 (JAX `_conv_w_grad` with preferred_element_type=f32): one GEMM
    over the pixels per tap.  Not cuDNN's weight gradient, whose float32
    algorithms (FFT, Winograd) measured 2e-4 of max |dW| away from a
    float64 reference at [2*7,180,320,64] on the H100."""
    b, h, w, ci = x.shape
    xp = F.pad(acc_dtype(x), (0, 0, 1, 1, 1, 1))
    d = acc_dtype(dy).reshape(-1, dy.shape[-1])
    return torch.stack([torch.stack([xp[:, ky:ky + h, kx:kx + w].reshape(-1, ci).T @ d
                                     for kx in range(3)]) for ky in range(3)])


def pfrb_bwd_b_ref(dz2, i1, base, w2f, w2b):
    """Kernel B's backward (kernel 5) from dz2 = d_out * lrelu'(i2):

        d_i1   = convT(dz2_t, W2f)              [N,T,H,W,C], activation dtype
        dzsum  = sum_t dz2_t   (float32 sum, rounded to the activation dtype)
        d_base = convT(dzsum, W2b)              [N,H,W,C]
        dW2f, dW2b [3,3,C,C], db2 [C]           float32

    (pfnl_tpu pfrb_pack.py `_chain_manual_bwd`, :487-493)."""
    n, t, h, w, c = dz2.shape
    dz2_4 = dz2.reshape(n * t, h, w, c)
    d_i1 = conv2d_same(dz2_4, mirror_t(w2f)).reshape(n, t, h, w, c)
    dzsum = acc_dtype(dz2).sum(1).to(dz2.dtype)
    d_base = conv2d_same(dzsum, mirror_t(w2b))
    dw2f = conv_w_grad(i1.reshape(n * t, h, w, c), dz2_4)
    dw2b = conv_w_grad(base, dzsum)
    db2 = acc_dtype(dz2).sum((0, 1, 2, 3))
    return d_i1.contiguous(), d_base.contiguous(), dw2f, dw2b, db2


def pfrb_bwd_a_ref(dz1, feat, g, w1):
    """Kernel A's backward (kernel 6) from dz1 = d_i1 * lrelu'(i1), with the
    block's output cotangent g carried through the residual:

        d_feat = g + convT(dz1_t, W1)           [N,T,H,W,C], activation dtype
        dW1 [3,3,C,C], db1 [C]                  float32

    (pfnl_tpu pfrb_pack.py `_chain_manual_bwd`, :501-505)."""
    n, t, h, w, c = dz1.shape
    dz1_4 = dz1.reshape(n * t, h, w, c)
    d_feat = g + conv2d_same(dz1_4, mirror_t(w1)).reshape(n, t, h, w, c)
    dw1 = conv_w_grad(feat.reshape(n * t, h, w, c), dz1_4)
    db1 = acc_dtype(dz1).sum((0, 1, 2, 3))
    return d_feat.contiguous(), dw1, db1


def _fold_index(c12: int) -> np.ndarray:
    """[3,3,4*c12,4*c12] int64: for each LR entry of the folded kernel, the
    flat index of the HR tap of km2 [3,3,c12,c12] it holds, or 9*c12*c12
    (a zero appended after km2) where it holds none."""
    idx = np.full((3, 3, 4 * c12, 4 * c12), 9 * c12 * c12, np.int64)
    ci, co = np.meshgrid(np.arange(c12), np.arange(c12), indexing="ij")
    for pr in range(2):
        for pc in range(2):
            for dy in range(3):
                for dx in range(3):
                    ry, rx = pr + dy - 1, pc + dx - 1     # HR offset from 2r/2c
                    sr, sc = ry % 2, rx % 2               # input sub-pixel
                    dy_lr, dx_lr = (ry - sr) // 2, (rx - sc) // 2
                    s, p = sr * 2 + sc, pr * 2 + pc
                    dst = idx[dy_lr + 1, dx_lr + 1, s * c12:(s + 1) * c12, p * c12:(p + 1) * c12]
                    assert (dst == 9 * c12 * c12).all(), "two HR taps in one LR entry"
                    dst[...] = ((dy * 3 + dx) * c12 + ci) * c12 + co
    return idx


def fold_d2s_conv(km2: torch.Tensor) -> torch.Tensor:
    """Fold conv3x3-after-depth_to_space(2) onto the LR grid.

    km2: [3,3,C12,C12] HR kernel -> [3,3,4*C12,4*C12] LR kernel whose input
    channel s*C12+ci is the d2s sub-pixel group s=(sr*2+sc) and output
    channel p*C12+co the output phase p=(pr*2+pc).  Each LR entry receives
    at most one HR tap, so the fold is exact in any dtype.  One gather
    through an index held on the device (a loop of slice updates would
    launch 37 kernels per call, which set the time of a PFNL tail call)."""
    c12 = km2.shape[-1]
    idx = on_device(("fold_d2s", c12), lambda: _fold_index(c12), km2.device, torch.int64)
    return torch.cat([km2.reshape(-1), km2.new_zeros(1)])[idx]


def pfnl_tail_ref(feat5, wm1, bm1, km2, bm2):
    """Merge tail on the LR grid: [N,T,H,W,C] -> folded [N,H,W,48] with
    channel (pr*2+pc)*12 + c12, the map kernel 4 writes.

        m   = lrelu(conv3x3(concat_t feat_t, Wm1) + bm1)         448 -> 48
        out = conv3x3(m, fold_d2s_conv(Wm2)) + tile(bm2, 4)     48 -> 48
    """
    n, t, h, w, c = feat5.shape
    dt = feat5.dtype
    merge = feat5.permute(0, 2, 3, 1, 4).reshape(n, h, w, t * c)
    m = leaky_relu(conv2d_same(merge, wm1) + bm1.to(dt))
    out = conv2d_same(m, fold_d2s_conv(km2.to(dt))) + bm2.to(dt).repeat(4)
    return out.contiguous()


def tail_only_ref(feat5, wm1, bm1, km2, bm2):
    """The unfolded tail as the reference writes it (JAX `_xla_tail_only`):
    merge conv, d2s, 12->12 conv at 2x, d2s -> [N,4H,4W,3]."""
    n, t, h, w, c = feat5.shape
    dt = feat5.dtype
    merge = feat5.permute(0, 2, 3, 1, 4).reshape(n, h, w, t * c)
    m = leaky_relu(conv2d_same(merge, wm1) + bm1.to(dt))
    o = conv2d_same(depth_to_space(m, 2), km2) + bm2.to(dt)
    return depth_to_space(o, 2)


def compose_d2s4(folded: torch.Tensor) -> torch.Tensor:
    """[N,h,w,48] folded map -> [N,4h,4w,3]: the double depth_to_space the
    fold moved out of the tail.  Channel layout (pr, pc, s2r, s2c, c3)."""
    n, h, w, _ = folded.shape
    x = folded.reshape(n, h, w, 2, 2, 2, 2, 3)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)       # n,h,pr,s2r,w,pc,s2c,c3
    return x.reshape(n, 4 * h, 4 * w, 3)
