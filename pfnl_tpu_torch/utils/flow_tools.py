"""Optical-flow utilities: a copy of pfnl_tpu/utils/flow_tools.py, which
is numpy only but belongs to the JAX package, which the port does not
import (reference modules/flowTools.py, a Python-2-only debug module
rebuilt py3-clean, and the TF flowToColor at
modules/videosr_ops.py:140-225).

  * Middlebury .flo read/write
  * AAE / EPE flow error metrics
  * Middlebury color-wheel flow visualization (numpy)
"""

import numpy as np

_TAG_FLOAT = 202021.25


def read_flo(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        tag = np.frombuffer(f.read(4), np.float32)[0]
        if tag != _TAG_FLOAT:
            raise ValueError(f"{path}: bad .flo magic {tag}")
        w = int(np.frombuffer(f.read(4), np.int32)[0])
        h = int(np.frombuffer(f.read(4), np.int32)[0])
        data = np.frombuffer(f.read(h * w * 2 * 4), np.float32)
    return data.reshape(h, w, 2).copy()


def write_flo(path: str, flow: np.ndarray) -> None:
    h, w, c = flow.shape
    assert c == 2
    with open(path, "wb") as f:
        np.float32(_TAG_FLOAT).tofile(f)
        np.int32(w).tofile(f)
        np.int32(h).tofile(f)
        flow.astype(np.float32).tofile(f)


def flow_epe(flow: np.ndarray, gt: np.ndarray) -> float:
    """Average end-point error."""
    return float(np.mean(np.sqrt(np.sum((flow - gt) ** 2, axis=-1))))


def flow_aae(flow: np.ndarray, gt: np.ndarray) -> float:
    """Average angular error (degrees), Barron et al. convention."""
    num = 1.0 + np.sum(flow * gt, axis=-1)
    den = np.sqrt(1.0 + np.sum(flow**2, -1)) * np.sqrt(1.0 + np.sum(gt**2, -1))
    ang = np.arccos(np.clip(num / den, -1.0, 1.0))
    return float(np.degrees(np.mean(ang)))


def _make_colorwheel() -> np.ndarray:
    """Middlebury color wheel (reference videosr_ops.py:141-177)."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    ncols = RY + YG + GC + CB + BM + MR
    cw = np.zeros([ncols, 3], np.float32)
    col = 0
    cw[0:RY, 0] = 255.0
    cw[0:RY, 1] = np.floor(255.0 / RY * np.arange(RY))
    col += RY
    cw[col : col + YG, 0] = 255.0 - np.floor(255.0 / YG * np.arange(YG))
    cw[col : col + YG, 1] = 255.0
    col += YG
    cw[col : col + GC, 1] = 255.0
    cw[col : col + GC, 2] = np.floor(255.0 / GC * np.arange(GC))
    col += GC
    cw[col : col + CB, 1] = 255.0 - np.floor(255.0 / CB * np.arange(CB))
    cw[col : col + CB, 2] = 255.0
    col += CB
    cw[col : col + BM, 2] = 255.0
    cw[col : col + BM, 0] = np.floor(255.0 / BM * np.arange(BM))
    col += BM
    cw[col : col + MR, 2] = 255.0 - np.floor(255.0 / MR * np.arange(MR))
    cw[col : col + MR, 0] = 255.0
    return cw


def flow_to_color(flow: np.ndarray, max_flow: float = None) -> np.ndarray:
    """[H,W,2] flow -> uint8 [H,W,3] Middlebury visualization
    (reference videosr_ops.py:140-225, numpy)."""
    u = flow[..., 0].astype(np.float64)
    v = flow[..., 1].astype(np.float64)
    eps = 2.2204e-16
    maxrad = max_flow if max_flow is not None else max(np.sqrt(u**2 + v**2).max(), eps)
    u = u / (maxrad + eps)
    v = v / (maxrad + eps)
    rad = np.sqrt(u**2 + v**2)

    cw = _make_colorwheel()
    ncols = cw.shape[0]
    a = np.arctan2(-v, -u) / np.pi
    fk = (a + 1) / 2 * (ncols - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % ncols
    f = (fk - k0)[..., None]
    col = (1 - f) * cw[k0] / 255.0 + f * cw[k1] / 255.0
    idx = rad <= 1
    col[idx] = 1 - rad[idx, None] * (1 - col[idx])
    col[~idx] = col[~idx] * 0.75
    return np.floor(255.0 * col).astype(np.uint8)
