"""Per-model loss graphs (counterpart: pfnl_tpu/train/losses.py), PFNL
family so far.

A loss function takes (out: dict from the model, gt: [B,Tg,H,W,3] float
RGB, lr: [B,T,h,w,3]) and returns a dict with:
  "loss"     the joint objective
  "loss_sr"  the SR-only objective
"""

from pfnl_tpu_torch.ops.losses import charbonnier


def pfnl_loss(out, gt, lr):
    """Charbonnier (reference model/pfnl.py:89)."""
    loss = charbonnier(out["sr"], gt)
    return {"loss": loss, "loss_sr": loss}


LOSS_REGISTRY = {
    "pfnl": pfnl_loss,
}
