"""TF-SAME convolutions on NHWC activations with HWIO kernels, the layouts
flax stores (counterpart: `lax.conv_general_dilated(..., "SAME")` and
`lax.conv_transpose(..., "SAME")` in the JAX package).  The kernel is cast
to the activation's dtype, as flax casts it.
"""

import torch
import torch.nn.functional as F


def conv2d_same(x: torch.Tensor, k: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """TF pads (out-1)*stride + k - n in total, the smaller half first, so
    a stride-2 k=5 conv over an even size pads (1, 2):
    `F.conv2d(padding=k//2, stride=2)` would be off by a row and a column."""
    _, h, w, _ = x.shape

    def pads(size, ksize):
        total = max((-(-size // stride) - 1) * stride + ksize - size, 0)
        return total // 2, total - total // 2

    (pt, pb), (pl, pr) = pads(h, k.shape[0]), pads(w, k.shape[1])
    xc, kc = x.permute(0, 3, 1, 2), k.to(x.dtype).permute(3, 2, 0, 1)
    if pt == pb and pl == pr:  # e.g. odd windows at stride 1: the conv pads itself
        y = F.conv2d(xc, kc, stride=stride, padding=(pt, pl))
    else:
        y = F.conv2d(F.pad(xc, (pl, pr, pt, pb)), kc, stride=stride)
    return y.permute(0, 2, 3, 1)


def conv_transpose_same2(x: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """`lax.conv_transpose(x, k, (2, 2), "SAME")` with a 4x4 or 3x3 HWIO
    kernel (flax's transpose_kernel=False): [N,h,w,Ci] -> [N,2h,2w,Co].  It
    is torch's transposed conv of the spatially FLIPPED kernel, laid out
    [Ci,Co,kh,kw]: with padding 1 for k=4; with padding 0 for k=3, keeping
    the first 2h rows and 2w columns of the 2h+1 by 2w+1 result (TF pads
    the odd total k + 1 - 2 = 2 of a stride-2 k=3 window as (2, 1): the
    three other crops are wrong)."""
    ksize = tuple(k.shape[:2])
    if ksize not in ((4, 4), (3, 3)):
        raise ValueError(f"conv_transpose_same2 takes a 4x4 or 3x3 kernel, got {tuple(k.shape)}")
    wt = k.to(x.dtype).flip(0, 1).permute(2, 3, 0, 1)
    xc = x.permute(0, 3, 1, 2)
    if ksize == (4, 4):
        y = F.conv_transpose2d(xc, wt, stride=2, padding=1)
    else:
        _, _, h, w = xc.shape
        y = F.conv_transpose2d(xc, wt, stride=2)[:, :, :2 * h, :2 * w]
    return y.permute(0, 2, 3, 1)
