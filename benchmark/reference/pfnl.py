"""PFNL's forward pass, plain PyTorch, float32 (Yi et al., ICCV 2019;
reference repository `model/pfnl.py`, the non-local block `utils.py:18-71`).

    x [N,T,h,w,3]
    frames concatenated on channels, space_to_depth(2), Gaussian non-local
    block (theta = phi = input, g and w 1x1 convs with bias, no scaling of
    the scores), depth_to_space(2), residual added;
    conv0 5x5 3 -> mf on each frame, leaky ReLU 0.2;
    num_blocks progressive fusion residual blocks, each:
        i1_t = lrelu(conv3x3(feat_t, W1) + b1)
        base = lrelu(sum_t i1_t @ Wfuse_t + bfuse)         (1x1 over the concat)
        feat_t += lrelu(conv3x3(concat(i1_t, base), W2) + b2)
    (W2 over the concat written as its two halves, conv2f over i1_t and
    conv2b over base, which is the same sum);
    merge: concat frames, conv3x3 T mf -> 48, lrelu, depth_to_space(2),
    conv3x3 12 -> 12, depth_to_space(2) -> [N,4h,4w,3];
    + the bicubic x4 of the centre frame.

Weights are a dict keyed by the program's parameter names (flax's, as the
port keeps them).  `prec` rounds every layer's operands and output (see
ops.Precision); the reference is float32 (`ops.FLOAT32`).

The benchmark's entries (benchmark/core.py `reference`): `LR_MULTIPLE` and
`serve` for serving, `train_loss` for training (the Charbonnier loss,
reference `model/pfnl.py:89`).
"""

import torch

from benchmark.reference.ops import (FLOAT32, attention, conv2d_same, depth_to_space, lrelu,
                                     resize_bicubic, space_to_depth)

LR_MULTIPLE = 2  # the space-to-depth of the non-local block


def forward(p, x, num_blocks: int, prec=FLOAT32):
    """x [N,T,h,w,3] float32 -> SR [N,4h,4w,3] float32."""
    n, t, h, w, c = x.shape
    x = prec(x)
    inp0 = x.permute(0, 2, 3, 1, 4).reshape(n, h, w, t * c)

    s = space_to_depth(inp0, 2)
    ns, hs, ws, cs = s.shape
    g = prec(conv2d_same(s, p["nlblock_0.g.kernel"], prec) + prec(p["nlblock_0.g.bias"]))
    flat = s.reshape(ns, hs * ws, cs)
    y = prec(attention(flat, flat, g.reshape(ns, hs * ws, cs))).reshape(ns, hs, ws, cs)
    nl = prec(conv2d_same(y, p["nlblock_0.w.kernel"], prec) + prec(p["nlblock_0.w.bias"]))
    inp0 = prec(inp0 + depth_to_space(nl, 2))

    frames = inp0.reshape(n, h, w, t, c).permute(0, 3, 1, 2, 4).reshape(n * t, h, w, c)
    feat = prec(lrelu(conv2d_same(frames, p["conv0.kernel"], prec) + prec(p["conv0.bias"])))
    mf = feat.shape[-1]
    for i in range(num_blocks):
        i1 = prec(lrelu(conv2d_same(feat, p[f"conv1_{i}_kernel"], prec)
                        + prec(p[f"conv1_{i}_bias"])))
        base = torch.einsum("nthwc,tcd->nhwd", i1.reshape(n, t, h, w, mf),
                            prec(p[f"conv10_{i}_kernel"]))
        base = prec(lrelu(base + prec(p[f"conv10_{i}_bias"])))
        frame_part = conv2d_same(i1, p[f"conv2f_{i}_kernel"], prec).reshape(n, t, h, w, mf)
        base_part = conv2d_same(base, p[f"conv2b_{i}_kernel"], prec)
        i2 = lrelu(frame_part + base_part[:, None] + prec(p[f"conv2f_{i}_bias"]))
        feat = prec(feat + i2.reshape(n * t, h, w, mf))

    merge = feat.reshape(n, t, h, w, mf).permute(0, 2, 3, 1, 4).reshape(n, h, w, t * mf)
    m = prec(lrelu(conv2d_same(merge, p["convmerge1_kernel"], prec) + prec(p["convmerge1_bias"])))
    o = prec(conv2d_same(depth_to_space(m, 2), p["convmerge2_kernel"], prec)
             + prec(p["convmerge2_bias"]))
    bic = prec(resize_bicubic(x[:, t // 2], (4 * h, 4 * w)))
    return prec(depth_to_space(o, 2) + bic)


def serve(p, x, cfg, prec=FLOAT32):
    """A window batch x [N,T,h,w,3] of LR RGB -> HR RGB [N,4h,4w,3]."""
    return forward(p, x, cfg["num_blocks"], prec)


def train_loss(p, gt, lr, cfg):
    """The SR of the LR windows lr [B,T,h,w,3] against the centre frames of
    gt [B,T,4h,4w,3]: mean(sqrt((sr - gt)^2 + 1e-6))."""
    sr = forward(p, lr, cfg["num_blocks"])
    centre = gt[:, gt.shape[1] // 2]
    return torch.mean(torch.sqrt((sr - centre) ** 2 + 1e-6))
