"""DUF's dynamic per-pixel filtering (counterpart: pfnl_tpu/ops/dynfilter.py).

The reference's `DynFilter3D` (utils.py:330-348) expands each pixel's
zero-padded 1x5x5 neighbourhood with a constant identity conv, then takes
a per-pixel product with the predicted filters.  Here the expansion is
`F.unfold`, whose taps run row-major over (i, j) like the reference's
`np.eye` reshape.
"""

import torch
import torch.nn.functional as F


def dyn_filter_3d(x: torch.Tensor, filters: torch.Tensor, filter_size=(1, 5, 5)) -> torch.Tensor:
    """x [B,T,H,W] (T = filter_size[0], the centre frame), filters
    [B,H,W,T*fh*fw,R*R] (softmaxed over the taps) -> [B,H,W,R*R]."""
    ft, fh, fw = filter_size
    b, t, h, w = x.shape
    if t != ft:
        raise ValueError(f"dyn_filter_3d: x has {t} frames, the filter {ft}")
    patches = F.unfold(x, (fh, fw), padding=(fh // 2, fw // 2))     # [B, T*fh*fw, H*W]
    # unfold puts the frame outside the tap, the reference inside it
    patches = patches.reshape(b, ft, fh * fw, h, w).permute(0, 3, 4, 2, 1)
    patches = patches.reshape(b, h, w, fh * fw * ft)
    return torch.einsum("bhwp,bhwpr->bhwr", patches, filters)
