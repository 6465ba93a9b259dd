"""Shared model building blocks (counterpart: pfnl_tpu/models/blocks.py).

Parameters keep flax's names and layouts (a conv `kernel` is HWIO), so a
flax params tree maps onto the state_dict by name alone
(utils/weights.py).  They are float32 and are cast to the activation
dtype at use, as flax does for a module with `dtype=bf16`.
"""

import math

import torch
from torch import nn

from pfnl_tpu_torch.ops.conv import conv2d_same
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


# the std of N(0, 1) truncated to [-2, 2], which flax's variance_scaling initialisers divide out
TRUNC_STD = 0.87962566103423978


def truncated_normal(shape, std: float, generator=None) -> torch.Tensor:
    """N(0, std^2) truncated at two std, float32, by the inverse CDF
    (jax.random.truncated_normal's algorithm): one value per `torch.rand`
    value u, x = sqrt(2) erfinv(lo + (hi - lo) u) std with lo, hi =
    erf(-+sqrt(2)), in float64, clamped to [-2 std, 2 std].  The stream a
    draw takes is fixed by its shape, so the port's seeded weights do not
    depend on the torch version (nn.init.trunc_normal_ redraws by rejection
    in some versions, a stream whose length depends on the values).  u is
    drawn on the generator's device."""
    device = generator.device if generator is not None else None
    u = torch.rand(shape, generator=generator, device=device).double()
    lo, hi = math.erf(-math.sqrt(2.0)), math.erf(math.sqrt(2.0))
    x = math.sqrt(2.0) * torch.erfinv(lo + (hi - lo) * u) * std
    return x.clamp(-2 * std, 2 * std).float()


def conv_lecun(shape, generator=None) -> torch.Tensor:
    """flax's lecun_normal (nn.Conv's default) for a conv kernel: a normal
    of std sqrt(1 / fan_in) / TRUNC_STD truncated at two std, fan_in =
    every axis but the last."""
    return truncated_normal(shape, math.sqrt(1.0 / math.prod(shape[:-1])) / TRUNC_STD, generator)


class ConvParams(nn.Module):
    """A conv's `kernel` (HWIO) and zero-initialised `bias`, executed by
    the caller (flax ConvParams / nn.Conv parameter tree).  init: the
    kernel's random init, glorot_uniform (the JAX package's) by default."""

    def __init__(self, kshape, generator=None, init=conv_glorot):
        super().__init__()
        self.kernel = nn.Parameter(init(tuple(kshape), generator))
        self.bias = nn.Parameter(torch.zeros(kshape[-1]))


class Conv(ConvParams):
    """flax nn.Conv with padding "SAME" (any odd or even window, any
    stride), executed in the activation's dtype with the bias added."""

    def forward(self, x, stride: int = 1):
        return conv2d_same(x, self.kernel, stride) + self.bias.to(x.dtype)


class PReLU(nn.Module):
    """Per-channel PReLU, slope `alpha` zero-initialised (reference
    modules/videosr_ops.py:44-51; pfnl_tpu blocks.py PReLU), computed as
    relu(x) + alpha * (x - |x|) / 2."""

    def __init__(self, channels: int):
        super().__init__()
        self.alpha = nn.Parameter(torch.zeros(channels))

    def forward(self, x):
        return torch.relu(x) + self.alpha.to(x.dtype) * (x - x.abs()) * 0.5


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

    Attention (pfnl_tpu blocks.py:110-116): dense up to
    DENSE_POSITION_LIMIT positions (the training crops); above it kernel 1
    on a CUDA tensor, and streaming on the CPU or with plain=True.  Kernel
    1 has no backward, in either package: asking it for a gradient
    raises NotImplementedError."""

    def __init__(self, channels: int, generator=None):
        super().__init__()
        self.g = Conv1x1(channels, channels, generator)
        self.w = Conv1x1(channels, channels, generator)

    def forward(self, x, plain: bool = False):
        n, h, w, c = x.shape
        gf = self.g(x).reshape(n, h * w, c).contiguous()
        xf = x.reshape(n, h * w, c).contiguous()
        if h * w <= DENSE_POSITION_LIMIT:
            y = nonlocal_attention(xf, xf, gf)
        elif x.is_cuda and not plain:
            if torch.is_grad_enabled() and (gf.requires_grad or xf.requires_grad):
                raise NotImplementedError(
                    f"no backward for kernel 1 (nonlocal_flash) at {h * w} positions, above "
                    f"the dense limit {DENSE_POSITION_LIMIT}; train at smaller crops")
            y = nonlocal_flash(xf, xf, gf)
        else:
            y = nonlocal_attention_chunked(xf, xf, gf)
        return self.w(y.reshape(n, h, w, c))
