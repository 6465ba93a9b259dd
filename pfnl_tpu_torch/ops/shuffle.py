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


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """[N,H*r,W*r,C] -> [N,H,W,C*r*r], inverse of depth_to_space."""
    n, hr, wr, c = x.shape
    h, w = hr // r, wr // r
    x = x.reshape(n, h, r, w, r, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(n, h, w, r * r * c)
