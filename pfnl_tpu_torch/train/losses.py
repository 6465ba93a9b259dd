"""Per-model loss graphs (counterpart: pfnl_tpu/train/losses.py), every
family.

A loss function takes (out: dict from the model, gt: [B,Tg,H,W,3] float
RGB, lr: [B,T,h,w,3]) and returns a dict with:
  "loss"     the joint objective (stage 1, or the only stage)
  "loss_sr"  the SR-only objective (stage 0 of staged training)
plus named components for logging.
"""

import numpy as np
import torch

from pfnl_tpu_torch.ops.color import rgb2y
from pfnl_tpu_torch.ops.constants import on_device
from pfnl_tpu_torch.ops.losses import charbonnier, huber, total_variation
from pfnl_tpu_torch.ops.warp import backward_warp_local


def _flow_loss(out):
    """Photometric L1 of each frame against the backward-warped reference
    frame + 0.01 * TV of the flow (model/vespcn.py:121-127), reduced in
    float32 whatever the compute dtype."""
    uv = out["uv"].float()  # [B,T,h,w,2]
    frames_y = out["frames_y"].float()
    b, t, h, w, _ = uv.shape
    ref_rep = out["ref_y"].float()[:, None].expand(frames_y.shape)
    # every in-model flow is tanh-bounded (EasyFlow's two stages sum to < 2)
    warped = backward_warp_local(ref_rep, uv, max_disp=2)
    loss_data = torch.mean(torch.abs(frames_y - warped))
    uv4 = uv.reshape(b * t, h, w, 2)
    loss_tv = total_variation(uv4) / float(uv4.numel())
    return loss_data + 0.01 * loss_tv


def pfnl_loss(out, gt, lr):
    """Charbonnier (reference model/pfnl.py:89)."""
    loss = charbonnier(out["sr"], gt)
    return {"loss": loss, "loss_sr": loss}


def vespcn_like_loss(out, gt, lr):
    """Charbonnier on Y + 0.01 * flow loss (model/vespcn.py:108-130; the same
    for MCResNet and LTDVSR)."""
    loss_mse = charbonnier(out["sr"], rgb2y(gt))
    loss_flow = _flow_loss(out)
    return {"loss": loss_mse + 0.01 * loss_flow, "loss_sr": loss_mse, "loss_mse": loss_mse,
            "loss_flow": loss_flow}


def _frame_weights(t: int) -> np.ndarray:
    wts = np.linspace(0.5, 1.0, t)
    return (wts / wts.sum()).astype(np.float32)


def drvsr_loss(out, gt, lr):
    """Per-output-frame MSE weighted by linspace(0.5, 1, T) normalised
    (model/drvsr.py:38-39,196-222) + 0.01 * flow loss."""
    gt_y = rgb2y(gt)  # [B,1,H,W,1] broadcasts over T
    wts = on_device(("drvsr_loss", out["sr"].shape[1]), lambda: _frame_weights(out["sr"].shape[1]),
                    gt.device, torch.float32)
    mse_t = torch.mean((out["sr"] - gt_y) ** 2, dim=(0, 2, 3, 4))
    loss_mse = torch.sum(mse_t * wts)
    loss_flow = _flow_loss(out)
    return {"loss": loss_mse + 0.01 * loss_flow, "loss_sr": loss_mse, "loss_mse": loss_mse,
            "loss_flow": loss_flow}


def frvsr_loss(out, gt, lr):
    """SR MSE over all frames + flow-warp MSE (model/frvsr.py:142-147)."""
    sr_loss = torch.mean((out["sr"] - gt) ** 2)
    flow_loss = torch.mean((out["warps"] - lr[:, 1:]) ** 2)
    return {"loss": sr_loss + flow_loss, "loss_sr": sr_loss, "flow_loss": flow_loss}


def duf_loss(out, gt, lr):
    """delta-Huber, delta 0.01 (reference model/dufvsr.py:65)."""
    loss = huber(gt, out["sr"], 0.01)
    return {"loss": loss, "loss_sr": loss}


LOSS_REGISTRY = {
    "pfnl": pfnl_loss,
    "vespcn": vespcn_like_loss,
    "mcresnet": vespcn_like_loss,
    "ltdvsr": vespcn_like_loss,
    "drvsr": drvsr_loss,
    "frvsr": frvsr_loss,
    "duf": duf_loss,
}
