"""Kernel 4: the PFNL merge tail on the LR grid (csrc/pfnl_tail.cu).

Counterpart of `pfnl_tail_pack` in pfnl_tpu/ops/pallas/pfnl_tail.py; the
plain version is `pfnl_tail_ref` (ops/pfrb_ref.py).  `compose_d2s4` and
the bicubic add stay in PyTorch.
"""

import torch

from pfnl_tpu_torch.ops.cuda import _build
from pfnl_tpu_torch.ops.pfrb_ref import fold_d2s_conv, pfnl_tail_ref

CHANNELS, MERGE = 64, 48


def pfnl_tail(feat5, wm1, bm1, km2, bm2):
    """feat5 [N,T,H,W,64] -> folded [N,H,W,48] (channel (pr*2+pc)*12+c12)."""
    if feat5.device.type == "cpu":
        return pfnl_tail_ref(feat5, wm1, bm1, km2, bm2)
    _build.check_cuda_inputs("pfnl_tail", feat5)
    if feat5.dim() != 5 or feat5.shape[-1] != CHANNELS:
        raise ValueError(f"pfnl_tail: feat must be [N,T,H,W,{CHANNELS}], "
                         f"got {tuple(feat5.shape)}")
    n, t, h, w, c = feat5.shape
    if tuple(wm1.shape) != (3, 3, t * c, MERGE) or tuple(km2.shape) != (3, 3, 12, 12):
        raise ValueError(f"pfnl_tail: Wm1 {tuple(wm1.shape)} / Wm2 {tuple(km2.shape)} "
                         f"do not fit feat {tuple(feat5.shape)}")
    dt, dev = feat5.dtype, feat5.device
    sfx = _build.suffix(dt)
    wm1f = _build.weight_f32(wm1, dt, dev)
    bm1f = _build.weight_f32(bm1, dt, dev)
    wf = fold_d2s_conv(_build.weight_f32(km2, dt, dev)).contiguous()
    bf = _build.weight_f32(bm2, dt, dev).repeat(4).contiguous()
    m = torch.empty(n, h, w, MERGE, dtype=dt, device=dev)
    out = torch.empty(n, h, w, MERGE, dtype=dt, device=dev)
    _build.call(f"pfnl_tail_{sfx}", feat5, wm1f, bm1f, wf, bf, m, out, n, t, h, w)
    _build.launches["pfnl_tail"] += 1
    return out
