"""BT.601 studio-swing colour conversions on [0,1] floats (counterpart:
pfnl_tpu/ops/color.py, whose constants these are, down to the reference's
truncated inverse `_YCBCR_TINV`).  They act on the trailing channel axis
of any rank and keep the input's dtype: bf16 stays bf16.

`rgb2ycbcr_np` is the numpy float64 conversion of the MATLAB-equivalent
metric path (reference utils.py:194-212), which the published PSNR tables
are computed with (eval/metrics.py).
"""

import numpy as np
import torch

from pfnl_tpu_torch.ops.constants import on_device

_Y_SCALE = np.array([65.481, 128.553, 24.966], np.float32) / 255.0
_YCBCR_T = (
    np.array([[65.481, 128.553, 24.966], [-37.797, -74.203, 112.0], [112.0, -93.786, -18.214]],
             np.float32)
    / 255.0
)
_Y_OFFSET = np.float32(16.0 / 255.0)
_YCBCR_OFFSET = np.array([16.0, 128.0, 128.0], np.float32) / 255.0
# The reference hard-codes this (truncated) inverse (modules/videosr_ops.py:112).
_YCBCR_TINV = (
    np.array([[0.00456621, 0.0, 0.00625893],
              [0.00456621, -0.00153632, -0.00318811],
              [0.00456621, 0.00791071, 0.0]], np.float32)
    * 255.0
)


def _const(a: np.ndarray, x: torch.Tensor) -> torch.Tensor:
    """One of the module's constant arrays (so its id is a stable key) on x's device."""
    return on_device(("color", id(a)), lambda: a, x.device, x.dtype)


def rgb2y(x: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB -> [..., 1] Y; single-channel input passes through."""
    if x.shape[-1] == 1:
        return x
    return (x * _const(_Y_SCALE, x)).sum(-1, keepdim=True) + _const(_Y_OFFSET, x)


def rgb2ycbcr(x: torch.Tensor) -> torch.Tensor:
    """[..., 3] RGB -> [..., 3] YCbCr."""
    if x.shape[-1] == 1:
        return x
    return x @ _const(_YCBCR_T, x).T + _const(_YCBCR_OFFSET, x)


def ycbcr2rgb(x: torch.Tensor) -> torch.Tensor:
    """[..., 3] YCbCr -> [..., 3] RGB, through the truncated inverse."""
    if x.shape[-1] == 1:
        return x
    return (x - _const(_YCBCR_OFFSET, x)) @ _const(_YCBCR_TINV, x).T


def rgb2ycbcr_np(img: np.ndarray, max_val: float = 255.0) -> np.ndarray:
    """Numpy metric-path conversion; `img` in [0,255] (or [0,1] with
    max_val=1).  Bit-matches reference utils.py:194-212 (`_rgb2ycbcr`),
    which itself matches MATLAB's rgb2ycbcr on doubles."""
    t = np.array([[0.256788235294118, 0.504129411764706, 0.097905882352941],
                  [-0.148223529411765, -0.290992156862745, 0.439215686274510],
                  [0.439215686274510, -0.367788235294118, -0.071427450980392]])
    offset = np.array([16.0, 128.0, 128.0])
    if max_val == 1:
        offset = offset / 255.0
    return img @ t.T + offset
