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

# std of a N(0,1) truncated to [-2, 2], which flax's truncated_normal divides out
_TRUNC_STD = 0.87962566103423978


class _Gates(nn.Module):
    """The fused gate conv's `kernel` (HWIO) and `bias`, flax's names."""

    def __init__(self, k: int, cin: int, cout: int, generator=None):
        super().__init__()
        std = 1e-3 / _TRUNC_STD
        self.kernel = nn.Parameter(torch.empty(k, k, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))
        with torch.no_grad():
            nn.init.trunc_normal_(self.kernel, std=std, a=-2 * std, b=2 * std,
                                  generator=generator)


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
