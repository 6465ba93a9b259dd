"""Loss primitives (counterpart: pfnl_tpu/ops/losses.py).

  * charbonnier: mean(sqrt((x-y)^2 + eps)), eps=1e-6 — PFNL's training loss
    (reference model/pfnl.py:89) and the VESPCN-family per-element "mse"
    (model/vespcn.py:116).
  * total_variation: sum over images of abs row/col diffs, matching
    tf.image.total_variation (the flow loss, model/vespcn.py:126).

`huber` comes with DUF training.
"""

import torch


def charbonnier(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.mean(torch.sqrt((pred - target) ** 2 + eps))


def total_variation(images: torch.Tensor) -> torch.Tensor:
    """images: [N,H,W,C] -> scalar sum over the batch (TF semantics)."""
    dh = (images[:, 1:] - images[:, :-1]).abs()
    dw = (images[:, :, 1:] - images[:, :, :-1]).abs()
    return dh.sum() + dw.sum()
