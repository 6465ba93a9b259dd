"""Convolutional LSTM cell (counterpart: pfnl_tpu/ops/convlstm.py;
reference modules/BasicConvLSTMCell.py:41-156).

One fused SAME conv over concat([x, h]), named `gates` as in flax, gives
the four gates in (i, j, f, o) order; the forget gate gets a bias of 1.0.
The kernel is initialised from a truncated normal of std 1e-3 and the
bias at zero, as the reference does.
"""

import torch
from torch import nn

from pfnl_tpu_torch.ops.conv import conv2d_same


class _Gates(nn.Module):
    """The fused gate conv's `kernel` (HWIO) and `bias`, flax's names."""

    def __init__(self, k: int, cin: int, cout: int, generator=None):
        super().__init__()
        # here, not at the top: models/ imports this module through DRVSR
        from pfnl_tpu_torch.models.blocks import truncated_normal

        # flax's truncated_normal(stddev=1e-3) scales by 1e-3 alone (no TRUNC_STD)
        self.kernel = nn.Parameter(truncated_normal((k, k, cin, cout), 1e-3, generator))
        self.bias = nn.Parameter(torch.zeros(cout))


class ConvLSTMCell(nn.Module):
    def __init__(self, in_channels: int, features: int, kernel_size: int = 3,
                 forget_bias: float = 1.0, generator=None):
        super().__init__()
        self.features, self.forget_bias = features, forget_bias
        self.gates = _Gates(kernel_size, in_channels + features, 4 * features, generator)

    def forward(self, state, x):
        """state (c, h) and x [N,H,W,*] in one dtype -> ((c', h'), h')."""
        c, h = state
        gates = (conv2d_same(torch.cat([x, h], -1), self.gates.kernel)
                 + self.gates.bias.to(x.dtype))
        i, j, f, o = torch.chunk(gates, 4, dim=-1)
        new_c = c * torch.sigmoid(f + self.forget_bias) + torch.sigmoid(i) * torch.tanh(j)
        new_h = torch.tanh(new_c) * torch.sigmoid(o)
        return (new_c, new_h), new_h

    def zero_state(self, n: int, h: int, w: int, dtype, device):
        z = torch.zeros((n, h, w, self.features), dtype=dtype, device=device)
        return z, z
