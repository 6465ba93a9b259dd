"""HR -> LR degradation: 13x13 Gaussian blur (sigma 1.6) + stride-`scale`
decimation, after REFLECT padding of 6 (counterpart:
pfnl_tpu/ops/degrade.py).  It defines the LR domain of test inputs, so it
matches the JAX package's op to float rounding.
"""

import numpy as np
import torch
import torch.nn.functional as F

from pfnl_tpu_torch.ops.constants import on_device


def gaussian_kernel_2d(kernlen: int = 13, sigma: float = 1.6) -> np.ndarray:
    """Separable 2-D Gaussian equal to scipy.ndimage.gaussian_filter of a
    centred Dirac (a copy of the JAX package's helper: importing it there
    would load jax)."""
    radius = kernlen // 2
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 / (sigma * sigma) * x * x)
    phi /= phi.sum()
    return np.outer(phi, phi).astype(np.float32)


BLUR_KERNEL = gaussian_kernel_2d(13, 1.6)


def downsample_4d(x: torch.Tensor, scale: int = 4) -> torch.Tensor:
    """[N,H,W,C] -> [N,H//scale,W//scale,C]: reflect pad, then a depthwise
    cross-correlation with BLUR_KERNEL at stride `scale`, VALID."""
    k = on_device("blur", lambda: BLUR_KERNEL, x.device, x.dtype)
    kh = k.shape[0]
    pt, pb = (kh - 1) // 2, (kh - 1) - (kh - 1) // 2
    c = x.shape[-1]
    y = F.pad(x.permute(0, 3, 1, 2), (pt, pb, pt, pb), mode="reflect")
    wgt = k[None, None].expand(c, 1, kh, kh)
    y = F.conv2d(y, wgt, stride=scale, groups=c)
    return y.permute(0, 2, 3, 1)


def downsample(x: torch.Tensor, scale: int = 4) -> torch.Tensor:
    """[N,T,H,W,C] variant: folds T into the batch (reference utils.py:142-167)."""
    n, t, h, w, c = x.shape
    y = downsample_4d(x.reshape(n * t, h, w, c), scale)
    return y.reshape(n, t, y.shape[1], y.shape[2], c)
