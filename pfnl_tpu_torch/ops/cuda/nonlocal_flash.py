"""Kernel 1: streaming-softmax non-local attention (csrc/nonlocal_flash.cu).

Counterpart of pfnl_tpu/ops/pallas/nonlocal_flash.py; its plain version is
`nonlocal_attention_chunked` (ops/nonlocal_attn.py).
"""

import torch

from pfnl_tpu_torch.ops.cuda import _build
from pfnl_tpu_torch.ops.nonlocal_attn import nonlocal_attention_chunked

MAX_DIM = 96  # largest D and Dv the kernel takes


def nonlocal_flash(theta: torch.Tensor, phi: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """softmax(theta @ phi^T) @ g, no scale: theta [B,N,D], phi [B,M,D],
    g [B,M,Dv] -> [B,N,Dv] in g's dtype.  Forward only."""
    if theta.device.type == "cpu":
        return nonlocal_attention_chunked(theta, phi, g)
    _build.check_cuda_inputs("nonlocal_flash", theta, phi, g)
    if not theta.dtype == phi.dtype == g.dtype:
        raise TypeError(f"nonlocal_flash: mixed dtypes {theta.dtype}, {phi.dtype}, {g.dtype}")
    sfx = _build.suffix(g.dtype)
    b, n, d = theta.shape
    m, dv = g.shape[1], g.shape[2]
    if phi.shape != (b, m, d) or g.shape[0] != b:
        raise ValueError(f"nonlocal_flash: shapes {tuple(theta.shape)}, "
                         f"{tuple(phi.shape)}, {tuple(g.shape)} do not agree")
    if d > MAX_DIM or dv > MAX_DIM or min(b, n, m, d, dv) < 1:
        raise ValueError(f"nonlocal_flash: takes 1 <= D, Dv <= {MAX_DIM}, got D={d}, Dv={dv}")
    out = torch.empty(b, n, dv, dtype=g.dtype, device=g.device)
    _build.call(f"pfnl_nonlocal_flash_{sfx}", theta, phi, g, out, b, n, m, d, dv)
    _build.launches["nonlocal_flash"] += 1
    return out
