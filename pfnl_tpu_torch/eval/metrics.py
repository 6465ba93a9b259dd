"""Quality metrics (counterpart: pfnl_tpu/eval/metrics.py:18-75), both
metric families of the reference:

  * training-log PSNR: 10*log10(1/mse) on RGB floats (model/pfnl.py:139);
  * parity-table metrics: MATLAB-equivalent Y-channel PSNR on uint8 PNGs
    (matlab/compute_psnr.m via utils.py:194-212 rgb2ycbcr) and Wang SSIM
    with an 11x11 sigma=1.5 Gaussian window (modules/SSIM_Index.py:24-89,
    matlab/SSIM.m), in float64 on the host;
  * the eval-time SSIM, `compute_ssim_batch`: the same SSIM over image
    stacks in float32 on the device (the VESPCN-family Evaluator).

The two PSNRs are different quantities; the published tables use the
MATLAB-equivalent path on saved frames (eval/tables.py).
"""

import numpy as np
import torch
import torch.nn.functional as F

from pfnl_tpu_torch.ops.color import rgb2ycbcr_np


def psnr_from_mse(mse: np.ndarray) -> np.ndarray:
    """Training-log PSNR on [0,1] RGB mse (model/pfnl.py:139)."""
    return 10.0 * np.log10(1.0 / mse)


def _to_y(img: np.ndarray) -> np.ndarray:
    """uint8 (or [0,255] float) RGB -> Y channel, float64."""
    img = np.asarray(img, np.float64)
    if img.ndim == 3 and img.shape[-1] == 3:
        return rgb2ycbcr_np(img, 255)[..., 0]
    return np.squeeze(img)


def psnr_y_matlab(img1: np.ndarray, img2: np.ndarray) -> float:
    """matlab/compute_psnr.m: Y-channel PSNR on uint8 images."""
    y1, y2 = _to_y(img1), _to_y(img2)
    rmse = np.sqrt(np.mean((y1 - y2) ** 2))
    if rmse == 0:
        return float("inf")
    return float(20.0 * np.log10(255.0 / rmse))


def _gauss2d(shape=(11, 11), sigma=1.5) -> np.ndarray:
    """MATLAB fspecial('gaussian') (modules/SSIM_Index.py:92-105)."""
    m, n = [(s - 1.0) / 2.0 for s in shape]
    y, x = np.ogrid[-m:m + 1, -n:n + 1]
    h = np.exp(-(x * x + y * y) / (2.0 * sigma * sigma))
    h[h < np.finfo(h.dtype).eps * h.max()] = 0
    s = h.sum()
    if s != 0:
        h /= s
    return h


def compute_ssim(im1: np.ndarray, im2: np.ndarray, l: float = 255.0) -> float:
    """Wang SSIM, transcribing modules/SSIM_Index.py:24-89 (scipy's
    reflect-boundary convolution)."""
    import scipy.ndimage as ndi

    c1 = (0.01 * l) ** 2
    c2 = (0.03 * l) ** 2
    window = _gauss2d((11, 11), 1.5)
    im1 = im1.astype(np.float64)
    im2 = im2.astype(np.float64)
    mu1 = ndi.convolve(im1, window)
    mu2 = ndi.convolve(im2, window)
    mu1_sq, mu2_sq, mu12 = mu1**2, mu2**2, mu1 * mu2
    s1 = ndi.convolve(im1 * im1, window) - mu1_sq
    s2 = ndi.convolve(im2 * im2, window) - mu2_sq
    s12 = ndi.convolve(im1 * im2, window) - mu12
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return float(np.mean(ssim_map))


def ssim_y_matlab(img1: np.ndarray, img2: np.ndarray) -> float:
    """Parity-table SSIM: Y channel of uint8 RGB images, L=255."""
    return compute_ssim(_to_y(img1), _to_y(img2), l=255.0)


def _symmetric_index(n: int, pad: int) -> np.ndarray:
    """Indices of numpy's "symmetric" pad (scipy.ndimage's "reflect": the
    edge sample repeated) of an axis of n samples by `pad` on each side."""
    i = np.arange(-pad, n + pad) % (2 * n)
    return np.where(i < n, i, 2 * n - 1 - i)


def compute_ssim_batch(im1: torch.Tensor, im2: torch.Tensor, l: float = 1.0) -> torch.Tensor:
    """Wang SSIM of each image of two [..., H, W] stacks on their device ->
    [...] float32 (counterpart: pfnl_tpu/eval/metrics.py:78-130): the window,
    formula and boundary of `compute_ssim` (the Gaussian window is
    symmetric, so the correlation is its convolution), computed in float32
    with TF32 off, as JAX's Precision.HIGHEST."""
    lead, (h, w) = im1.shape[:-2], im1.shape[-2:]
    x = im1.reshape(-1, 1, h, w).float()
    y = im2.reshape(-1, 1, h, w).float()
    window = torch.from_numpy(_gauss2d((11, 11), 1.5).astype(np.float32)).to(x.device)[None, None]
    rows = torch.from_numpy(_symmetric_index(h, 5)).to(x.device)
    cols = torch.from_numpy(_symmetric_index(w, 5)).to(x.device)

    def conv(v):
        return F.conv2d(v.index_select(2, rows).index_select(3, cols), window)

    c1 = (0.01 * l) ** 2
    c2 = (0.03 * l) ** 2
    cudnn = torch.backends.cudnn
    with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                     deterministic=cudnn.deterministic, allow_tf32=False):
        mu1, mu2 = conv(x), conv(y)
        mu1_sq, mu2_sq, mu12 = mu1 * mu1, mu2 * mu2, mu1 * mu2
        s1 = conv(x * x) - mu1_sq
        s2 = conv(y * y) - mu2_sq
        s12 = conv(x * y) - mu12
    ssim_map = ((2 * mu12 + c1) * (2 * s12 + c2)) / ((mu1_sq + mu2_sq + c1) * (s1 + s2 + c2))
    return ssim_map.mean(dim=(1, 2, 3)).reshape(lead)
