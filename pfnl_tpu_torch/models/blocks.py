"""Shared model building blocks (counterpart: pfnl_tpu/models/blocks.py).

Parameters keep flax's names and layouts (a conv `kernel` is HWIO), so a
flax params tree maps onto the state_dict by name alone
(utils/weights.py).  They are float32 and are cast to the activation
dtype at use, as flax does for a module with `dtype=bf16`.
"""

import math

import torch
from torch import nn

from pfnl_tpu_torch.ops.cuda.nonlocal_flash import nonlocal_flash
from pfnl_tpu_torch.ops.nonlocal_attn import nonlocal_attention, nonlocal_attention_chunked
from pfnl_tpu_torch.ops.pfrb_ref import leaky_relu  # noqa: F401  (public here, as in pfnl_tpu)

# Dense N^2 attention above this many positions would need the [B,N,N]
# score matrix; above it the plain path streams (pfnl_tpu blocks.py:14).
DENSE_POSITION_LIMIT = 4096


def glorot_uniform(shape, fan_in: int, fan_out: int, generator=None) -> torch.Tensor:
    """U(-l, l) with l = sqrt(6 / (fan_in + fan_out)), drawn from `generator`."""
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    return (torch.rand(shape, generator=generator) * 2.0 - 1.0) * limit


def conv_glorot(shape, generator=None) -> torch.Tensor:
    """flax's glorot_uniform for an HWIO conv kernel."""
    kh, kw, cin, cout = shape
    return glorot_uniform(shape, kh * kw * cin, kh * kw * cout, generator)


class ConvParams(nn.Module):
    """A conv's `kernel` (HWIO) and zero-initialised `bias`, executed by
    the caller (flax ConvParams / nn.Conv parameter tree)."""

    def __init__(self, kshape, generator=None):
        super().__init__()
        self.kernel = nn.Parameter(conv_glorot(tuple(kshape), generator))
        self.bias = nn.Parameter(torch.zeros(kshape[-1]))


class Conv1x1(ConvParams):
    """flax nn.Conv with a (1,1) window on channels-last input."""

    def __init__(self, cin: int, cout: int, generator=None):
        super().__init__((1, 1, cin, cout), generator)

    def forward(self, x):
        return x @ self.kernel[0, 0].to(x.dtype) + self.bias.to(x.dtype)


class NonLocalBlock(nn.Module):
    """Gaussian non-local block, nltype 1 (reference utils.py:18-71):
    theta = phi = input, `g` and `w` are 1x1 convs with bias.  Returns
    w(y) WITHOUT the residual; the caller adds it.

    Attention: kernel 1 on a CUDA tensor; on the CPU (or with plain=True)
    dense up to DENSE_POSITION_LIMIT positions and streaming above."""

    def __init__(self, channels: int, generator=None):
        super().__init__()
        self.g = Conv1x1(channels, channels, generator)
        self.w = Conv1x1(channels, channels, generator)

    def forward(self, x, plain: bool = False):
        n, h, w, c = x.shape
        gf = self.g(x).reshape(n, h * w, c).contiguous()
        xf = x.reshape(n, h * w, c).contiguous()
        if x.is_cuda and not plain:
            y = nonlocal_flash(xf, xf, gf)
        elif h * w <= DENSE_POSITION_LIMIT:
            y = nonlocal_attention(xf, xf, gf)
        else:
            y = nonlocal_attention_chunked(xf, xf, gf)
        return self.w(y.reshape(n, h, w, c))
