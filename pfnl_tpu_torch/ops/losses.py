"""Loss primitives (counterpart: pfnl_tpu/ops/losses.py).

  * charbonnier: mean(sqrt((x-y)^2 + eps)), eps=1e-6 — PFNL's training loss
    (reference model/pfnl.py:89) and the VESPCN-family per-element "mse"
    (model/vespcn.py:116).
  * huber: the delta-Huber with its gradient-safe linear term (reference
    utils.py:350-360), DUF's training loss (model/dufvsr.py:65).
  * total_variation: sum over images of abs row/col diffs, matching
    tf.image.total_variation (the flow loss, model/vespcn.py:126).
"""

import torch


def charbonnier(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.mean(torch.sqrt((pred - target) ** 2 + eps))


def huber(y_true: torch.Tensor, y_pred: torch.Tensor, delta: float) -> torch.Tensor:
    """mean(0.5 q^2 + delta (|e| - q)), q = min(|e|, delta), e = y_pred - y_true,
    written as the reference writes it (not F.huber_loss): where |e| = delta
    the minimum's gradient splits half and half as jnp.minimum's does, and
    at e = 0 the gradient is 0."""
    abs_error = (y_pred - y_true).abs()
    quadratic = torch.minimum(abs_error, torch.full_like(abs_error, delta))
    linear = abs_error - quadratic
    return torch.mean(0.5 * quadratic ** 2 + delta * linear)


def total_variation(images: torch.Tensor) -> torch.Tensor:
    """images: [N,H,W,C] -> scalar sum over the batch (TF semantics)."""
    dh = (images[:, 1:] - images[:, :-1]).abs()
    dw = (images[:, :, 1:] - images[:, :, :-1]).abs()
    return dh.sum() + dw.sum()
