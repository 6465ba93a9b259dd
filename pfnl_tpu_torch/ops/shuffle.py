"""Sub-pixel rearrangements in TF NHWC channel order.

TF's order puts the sub-pixel offset OUTSIDE the channel:
channel (dy*r+dx)*C + c.  `torch.pixel_shuffle` uses c*r*r + dy*r + dx, so
it is not a drop-in replacement (counterpart: pfnl_tpu/ops/shuffle.py).
"""

import torch


def depth_to_space(x: torch.Tensor, r: int) -> torch.Tensor:
    """[N,H,W,C*r*r] -> [N,H*r,W*r,C]:
    out[n, h*r+dy, w*r+dx, c] = in[n, h, w, (dy*r+dx)*C + c]."""
    n, h, w, crr = x.shape
    c = crr // (r * r)
    x = x.reshape(n, h, w, r, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h * r, w * r, c)


def depth_to_space_3d(x: torch.Tensor, r: int) -> torch.Tensor:
    """[N,T,H,W,C*r*r] -> [N,T,H*r,W*r,C]: T folded into the batch
    (reference utils.py:320-328)."""
    n, t, h, w, crr = x.shape
    y = depth_to_space(x.reshape(n * t, h, w, crr), r)
    return y.reshape(n, t, h * r, w * r, crr // (r * r))


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """[N,H*r,W*r,C] -> [N,H,W,C*r*r], inverse of depth_to_space."""
    n, hr, wr, c = x.shape
    h, w = hr // r, wr // r
    x = x.reshape(n, h, r, w, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h, w, r * r * c)


def pixel_shuffle_legacy(x: torch.Tensor, r: int, n_out: int) -> torch.Tensor:
    """The reference's `_PS` (modules/ps.py:3-15): split C into r groups,
    concat them along W, reshape to [N,H*r,W*r,n_out].  That is
    depth_to_space with the channel count checked."""
    if x.shape[-1] != r * r * n_out:
        raise ValueError(f"_PS: C={x.shape[-1]} != r^2*n_out={r * r * n_out}")
    return depth_to_space(x, r)
