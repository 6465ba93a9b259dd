"""Loss primitives (counterpart: pfnl_tpu/ops/losses.py).

  * charbonnier: mean(sqrt((x-y)^2 + eps)), eps=1e-6 — PFNL's training loss
    (reference model/pfnl.py:89).

`huber` and `total_variation` come with the families that use them.
"""

import torch


def charbonnier(pred: torch.Tensor, target: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    return torch.mean(torch.sqrt((pred - target) ** 2 + eps))
