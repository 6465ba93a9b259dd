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


def _matrix(n_in, n_out, method, mapping, device, dtype):
    return on_device(("resize", n_in, n_out, method, mapping),
                     lambda: _resize_matrix(n_in, n_out, method, mapping), device, dtype)


def _compute_dtype(x):
    return torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32


def _apply(wh, ww, x):
    y = torch.einsum("oh,nhwc->nowc", wh, x.to(wh.dtype))
    y = torch.einsum("pw,nowc->nopc", ww, y)
    return y.to(x.dtype)


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
    _, h, w, _ = x.shape
    compute = _compute_dtype(x)
    wh = _matrix(h, out_h, method, mapping, x.device, compute)
    ww = _matrix(w, out_w, method, mapping, x.device, compute)
    return _apply(wh, ww, x)


def resize_rows(x: torch.Tensor, full_h: int, row0: int, size, out_rows,
                method: str = "bicubic", mapping: str = "tf1",
                strict: bool = True) -> torch.Tensor:
    """Output rows out_rows = (lo, hi) of `resize_images(image, size)` for an
    image of full_h rows of which x [N,h,W,C] holds rows row0..row0+h (a
    band of rows and its halo, parallel/spmd.py); raises where those output
    rows read a row x does not hold, unless strict=False, which drops those
    reads (the output rows that make them are wrong, and a band's halo must
    cover them).  The products are resize_images' with the rows of its
    height matrix cut to the band."""
    lo, hi = out_rows
    h = x.shape[1]
    full = _resize_matrix(full_h, int(size[0]), method, mapping)
    if strict and (full[lo:hi, :row0].any() or full[lo:hi, row0 + h:].any()):
        raise ValueError(f"output rows {lo}..{hi} read input rows outside {row0}..{row0 + h}")
    compute = _compute_dtype(x)
    wh = _matrix(full_h, int(size[0]), method, mapping, x.device, compute)[lo:hi, row0:row0 + h]
    ww = _matrix(x.shape[2], int(size[1]), method, mapping, x.device, compute)
    return _apply(wh, ww, x)


def resize_bicubic(x: torch.Tensor, size) -> torch.Tensor:
    return resize_images(x, size, "bicubic")


def resize_bilinear(x: torch.Tensor, size, mapping: str = "tf1") -> torch.Tensor:
    return resize_images(x, size, "bilinear", mapping)
