"""Model families of the port: PFNL, the Y-channel flow families, FRVSR and DUF."""

from pfnl_tpu_torch.models.drvsr import DRVSR
from pfnl_tpu_torch.models.duf import DUF
from pfnl_tpu_torch.models.frvsr import FRVSR
from pfnl_tpu_torch.models.ltdvsr import LTDVSR
from pfnl_tpu_torch.models.mcresnet import MCResNet
from pfnl_tpu_torch.models.pfnl import PFNL
from pfnl_tpu_torch.models.vespcn import VESPCN

MODEL_REGISTRY = {"pfnl": PFNL, "vespcn": VESPCN, "mcresnet": MCResNet, "ltdvsr": LTDVSR,
                  "drvsr": DRVSR, "frvsr": FRVSR, "duf": DUF}

__all__ = ["PFNL", "VESPCN", "MCResNet", "LTDVSR", "DRVSR", "FRVSR", "DUF", "MODEL_REGISTRY"]
