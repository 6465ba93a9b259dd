"""Model families of the port (PFNL only so far)."""

from pfnl_tpu_torch.models.pfnl import PFNL

__all__ = ["PFNL"]
