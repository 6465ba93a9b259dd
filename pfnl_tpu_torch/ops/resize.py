"""Separable image resize as two dense resampling matrices.

TF1 `resize_images(align_corners=False)` legacy mapping: `src = dst*in/out`
(no half-pixel offset), Keys cubic a = -0.75, taps clamped at the border
(counterpart: pfnl_tpu/ops/resize.py); `mapping="align_corners"` is TF1's
`align_corners=True`, `src = dst*(in-1)/(out-1)` (FlowNet's pre and post
resizes, reference modules/model_flownet.py:252,315).  The matrices are built in numpy;
the product is a plain matmul, as the JAX package leaves it to XLA.
"""

import functools

import numpy as np
import torch

from pfnl_tpu_torch.ops.constants import on_device


def _keys_cubic(x: np.ndarray, a: float = -0.75) -> np.ndarray:
    x = np.abs(x)
    out = np.where(x <= 1.0, (a + 2.0) * x**3 - (a + 3.0) * x**2 + 1.0, 0.0)
    out = np.where((x > 1.0) & (x < 2.0), a * x**3 - 5.0 * a * x**2 + 8.0 * a * x - 4.0 * a, out)
    return out


def _triangle(x: np.ndarray) -> np.ndarray:
    return np.maximum(0.0, 1.0 - np.abs(x))


@functools.lru_cache(maxsize=64)
def _resize_matrix(n_in: int, n_out: int, method: str, mapping: str) -> np.ndarray:
    """Dense [n_out, n_in] float32 resampling matrix (a copy of the JAX
    package's helper: importing it there would load jax)."""
    if method == "bilinear":
        kernel, support = _triangle, 1
    elif method == "bicubic":
        kernel, support = _keys_cubic, 2
    else:
        raise ValueError(f"unknown resize method: {method}")

    dst = np.arange(n_out, dtype=np.float64)
    scale = n_in / n_out
    if mapping == "tf1":
        src = dst * scale
    elif mapping == "half_pixel":
        src = (dst + 0.5) * scale - 0.5
    elif mapping == "align_corners":
        src = dst * ((n_in - 1) / max(n_out - 1, 1))
    else:
        raise ValueError(f"unknown coordinate mapping: {mapping}")

    base = np.floor(src).astype(np.int64)
    w = np.zeros((n_out, n_in), dtype=np.float64)
    for tap in range(-support + 1, support + 1):
        idx = base + tap
        weight = kernel(src - idx)
        np.add.at(w, (dst.astype(np.int64), np.clip(idx, 0, n_in - 1)), weight)
    return w.astype(np.float32)


def resize_images(x: torch.Tensor, size, method: str = "bilinear",
                  mapping: str = "tf1") -> torch.Tensor:
    """[N,H,W,C] or [N,T,H,W,C] -> spatial size (H',W'); a 5-D input folds
    T into the batch (reference modules/videosr_ops.py:60-68).  bf16 stays
    bf16 through both products; every other dtype computes in float32."""
    if x.dim() == 5:
        n, t = x.shape[:2]
        y = resize_images(x.reshape((n * t,) + x.shape[2:]), size, method, mapping)
        return y.reshape((n, t) + y.shape[1:])
    out_h, out_w = int(size[0]), int(size[1])
    n, h, w, c = x.shape
    compute = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32

    def matrix(n_in, n_out):
        return on_device(("resize", n_in, n_out, method, mapping),
                         lambda: _resize_matrix(n_in, n_out, method, mapping), x.device, compute)

    wh, ww = matrix(h, out_h), matrix(w, out_w)
    y = torch.einsum("oh,nhwc->nowc", wh, x.to(compute))
    y = torch.einsum("pw,nowc->nopc", ww, y)
    return y.to(x.dtype)


def resize_bicubic(x: torch.Tensor, size) -> torch.Tensor:
    return resize_images(x, size, "bicubic")


def resize_bilinear(x: torch.Tensor, size, mapping: str = "tf1") -> torch.Tensor:
    return resize_images(x, size, "bilinear", mapping)
