"""Separable image resize as two dense resampling matrices.

TF1 `resize_images(align_corners=False)` legacy mapping: `src = dst*in/out`
(no half-pixel offset), Keys cubic a = -0.75, taps clamped at the border
(counterpart: pfnl_tpu/ops/resize.py).  The matrices are built in numpy;
the product is a plain matmul, as the JAX package leaves it to XLA.
"""

import functools

import numpy as np
import torch


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


def resize_bicubic(x: torch.Tensor, size) -> torch.Tensor:
    """[N,H,W,C] -> [N,H',W',C].  bf16 stays bf16 through both products;
    every other dtype computes in float32."""
    out_h, out_w = int(size[0]), int(size[1])
    n, h, w, c = x.shape
    compute = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
    wh = torch.as_tensor(_resize_matrix(h, out_h, "bicubic", "tf1"), device=x.device).to(compute)
    ww = torch.as_tensor(_resize_matrix(w, out_w, "bicubic", "tf1"), device=x.device).to(compute)
    y = torch.einsum("oh,nhwc->nowc", wh, x.to(compute))
    y = torch.einsum("pw,nowc->nopc", ww, y)
    return y.to(x.dtype)
