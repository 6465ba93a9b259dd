"""Plain PyTorch versions of the PFRB chain (kernels 2 and 3) and of the
PFNL merge tail (kernel 4).  Counterparts: pfnl_tpu/ops/pallas/pfrb_xla.py
and `_xla_tail_only` / `compose_d2s4` / `_fold_d2s_conv` in
pfnl_tpu/ops/pallas/pfnl_tail.py.

One PFRB, per sample (T frames, C = 64 channels, HWIO kernels):

    i1_t  = lrelu(conv3x3(feat_t, W1) + b1)                     kernel A
    base  = lrelu(sum_t i1_t @ Wfuse_t + bfuse)                 kernel A
    out_t = feat_t + lrelu(conv3x3(i1_t, W2f)
                           + conv3x3(base, W2b) + b2)           kernel B

Weights are cast to the activation dtype at use, as the JAX package does.
"""

import torch
import torch.nn.functional as F

from pfnl_tpu_torch.ops.shuffle import depth_to_space


def leaky_relu(x, alpha: float = 0.2):
    """tf.nn.leaky_relu's default alpha 0.2, as max(x, alpha*x)."""
    return torch.maximum(x, alpha * x)


def conv_same(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Stride-1 SAME conv, NHWC activations and an HWIO (odd-sized) kernel."""
    y = F.conv2d(x.permute(0, 3, 1, 2), k.to(x.dtype).permute(3, 2, 0, 1),
                 padding=k.shape[0] // 2)
    return y.permute(0, 2, 3, 1)


def pfrb_a_ref(feat, w1, b1, wfuse, bfuse):
    """feat [N,T,H,W,C] -> (i1 [N,T,H,W,C], base [N,H,W,C])."""
    n, t, h, w, c = feat.shape
    dt = feat.dtype
    i1 = leaky_relu(conv_same(feat.reshape(n * t, h, w, c), w1) + b1.to(dt))
    i1 = i1.reshape(n, t, h, w, c)
    base = leaky_relu(torch.einsum("nthwc,tcd->nhwd", i1, wfuse.to(dt)) + bfuse.to(dt))
    return i1.contiguous(), base.contiguous()


def pfrb_b_ref(feat, i1, base, w2f, w2b, b2):
    """-> out [N,T,H,W,C] = feat + lrelu(conv(i1,W2f) + conv(base,W2b) + b2)."""
    n, t, h, w, c = feat.shape
    base_part = conv_same(base, w2b)
    frame_part = conv_same(i1.reshape(n * t, h, w, c), w2f).reshape(n, t, h, w, c)
    i2 = leaky_relu(frame_part + base_part[:, None] + b2.to(feat.dtype))
    return (feat + i2).contiguous()


def pfrb_block_ref(feat, w1, b1, wfuse, bfuse, w2f, w2b, b2):
    i1, base = pfrb_a_ref(feat, w1, b1, wfuse, bfuse)
    return pfrb_b_ref(feat, i1, base, w2f, w2b, b2)


def pfrb_chain_ref(feat, params_list):
    for p in params_list:
        feat = pfrb_block_ref(feat, *p)
    return feat


def fold_d2s_conv(km2: torch.Tensor) -> torch.Tensor:
    """Fold conv3x3-after-depth_to_space(2) onto the LR grid.

    km2: [3,3,C12,C12] HR kernel -> [3,3,4*C12,4*C12] LR kernel whose input
    channel s*C12+ci is the d2s sub-pixel group s=(sr*2+sc) and output
    channel p*C12+co the output phase p=(pr*2+pc).  Each LR entry receives
    at most one HR tap, so the fold is exact in any dtype."""
    c12 = km2.shape[-1]
    out = km2.new_zeros(3, 3, 4 * c12, 4 * c12)
    for pr in range(2):
        for pc in range(2):
            for dy in range(3):
                for dx in range(3):
                    ry, rx = pr + dy - 1, pc + dx - 1     # HR offset from 2r/2c
                    sr, sc = ry % 2, rx % 2               # input sub-pixel
                    dy_lr, dx_lr = (ry - sr) // 2, (rx - sc) // 2
                    s, p = sr * 2 + sc, pr * 2 + pc
                    out[dy_lr + 1, dx_lr + 1,
                        s * c12:(s + 1) * c12,
                        p * c12:(p + 1) * c12] += km2[dy, dx]
    return out


def pfnl_tail_ref(feat5, wm1, bm1, km2, bm2):
    """Merge tail on the LR grid: [N,T,H,W,C] -> folded [N,H,W,48] with
    channel (pr*2+pc)*12 + c12, the map kernel 4 writes.

        m   = lrelu(conv3x3(concat_t feat_t, Wm1) + bm1)         448 -> 48
        out = conv3x3(m, fold_d2s_conv(Wm2)) + tile(bm2, 4)     48 -> 48
    """
    n, t, h, w, c = feat5.shape
    dt = feat5.dtype
    merge = feat5.permute(0, 2, 3, 1, 4).reshape(n, h, w, t * c)
    m = leaky_relu(conv_same(merge, wm1) + bm1.to(dt))
    out = conv_same(m, fold_d2s_conv(km2.to(dt))) + bm2.to(dt).repeat(4)
    return out.contiguous()


def tail_only_ref(feat5, wm1, bm1, km2, bm2):
    """The unfolded tail as the reference writes it (JAX `_xla_tail_only`):
    merge conv, d2s, 12->12 conv at 2x, d2s -> [N,4H,4W,3]."""
    n, t, h, w, c = feat5.shape
    dt = feat5.dtype
    merge = feat5.permute(0, 2, 3, 1, 4).reshape(n, h, w, t * c)
    m = leaky_relu(conv_same(merge, wm1) + bm1.to(dt))
    o = conv_same(depth_to_space(m, 2), km2) + bm2.to(dt)
    return depth_to_space(o, 2)


def compose_d2s4(folded: torch.Tensor) -> torch.Tensor:
    """[N,h,w,48] folded map -> [N,4h,4w,3]: the double depth_to_space the
    fold moved out of the tail.  Channel layout (pr, pc, s2r, s2c, c3)."""
    n, h, w, _ = folded.shape
    x = folded.reshape(n, h, w, 2, 2, 2, 2, 3)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)       # n,h,pr,s2r,w,pc,s2c,c3
    return x.reshape(n, 4 * h, 4 * w, 3)
