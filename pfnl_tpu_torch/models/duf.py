"""DUF: Deep Video Super-Resolution Using Dynamic Upsampling Filters
(CVPR 2018), DUF-16L/28L/52L — counterpart of pfnl_tpu/models/duf.py
(reference model/dufvsr.py:19-58, model/nets.py FR_16L/28L/52L).

  x [N,T,h,w,3]
    -> conv1 1x3x3                                           [N,T,h,w,64]
    -> dense blocks: BN-relu-1x1x1-BN-relu-3x3x3, G new channels each;
       the last 3 temporally VALID (T 7 -> 1)                [N,1,h,w,C_fin]
       (kernel 9 for the whole loop, or kernel 10 per growth conv)
    -> fbn1-relu -> conv2 1x3x3 -> relu
    -> residual head rconv1-relu-rconv2                      [N,1,h,w,3*16]
    -> filter head fconv1-relu-fconv2, softmax over 25 taps  [N,1,h,w,25,16]
    -> per RGB channel of the centre frame, float32: dyn_filter_3d ->
       depth_to_space(4); + depth_to_space_3d(residual)
    -> [N,1,4h,4w,3] float32

BatchNorm is the reference's hand-rolled moving-average BN (utils.py:251-278):
eps 1e-3 and moving_variance initialised to 0 (the reference's quirk: an
untrained model's eval activations are about 1e17).  In training the moving
stats are TF's `zero_debias` averages (assign_moving_average(...,
zero_debias=True), pfnl_tpu/models/duf.py:101-159): a biased EMA
accumulator (`biased_mean`, `biased_var`, decay 0.999) and a step count
(`local_step`) beside each stat, the stored stat being biased / (1 -
0.999^t), so that after one update it equals the batch stat.  All five
`batch_stats` entries are buffers under flax's names, so a flax checkpoint
loads as it is (utils/weights.py).  A training-mode forward (`.train()`,
JAX's `is_train=True`) normalises by the batch statistics, gradients
flowing through them, and updates the five buffers once; an eval-mode
forward reads the moving statistics and updates nothing.

Parameters keep flax's names and layouts (`G.conv1.W` DHWIO, `G.Rbn3a.gamma`,
...), float32, cast to the activation dtype at use.
"""

import math
import re

import torch
import torch.nn.functional as F
from torch import nn

from pfnl_tpu_torch.ops.cuda.duf_block import dense_backbone
from pfnl_tpu_torch.ops.cuda.duf_dense import conv3x3x3
from pfnl_tpu_torch.ops.duf_ref import BlockParams
from pfnl_tpu_torch.ops.dynfilter import dyn_filter_3d
from pfnl_tpu_torch.ops.shuffle import depth_to_space, depth_to_space_3d

# layer count -> (SAME-T blocks, VALID-T blocks, growth, conv2's input channels)
FR_CONFIGS = {16: (3, 3, 32, 256), 28: (9, 3, 16, 256), 52: (21, 3, 16, 448)}
CONV3D_IMPLS = ("auto", "fused", "pallas", "xla")
_PADS = {"thw": (1, 1, 1), "hw": (0, 1, 1), "none": (0, 0, 0)}


def he_trunc_normal(shape, generator=None) -> torch.Tensor:
    """flax variance_scaling(2.0, "fan_in", "truncated_normal") for a DHWIO
    kernel: N(0, 2/fan_in) truncated at two standard deviations."""
    fan_in = math.prod(shape[:-1])
    std = math.sqrt(2.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(torch.empty(shape), std=std, a=-2 * std, b=2 * std,
                                 generator=generator)


def bn_cancelled_bias(name: str) -> bool:
    """Whether the DUF parameter `name` is a bias whose gradient is 0 in
    exact arithmetic in training: conv1's and each dense block's convs'
    outputs reach the loss only through training-mode BatchNorms, which
    remove any constant, so float32 leaves only rounding in them."""
    return re.fullmatch(r"G\.(conv1|Rconv\d+[ab])\.b", name) is not None


class Conv3D(nn.Module):
    """A VALID 3-D conv after a zero pad (F.conv3d's own padding), NDHWC
    activations and a DHWIO kernel `W` with bias `b`.  pad: "hw" pads H/W
    by 1 (reference `sp`), "thw" T/H/W by 1 (`stp`), "none" nothing.  impl="pallas" runs a
    padded 3x3x3 conv through kernel 10 (`conv3x3x3`, which pads H/W
    itself, and T for "thw"), unless plain=True."""

    def __init__(self, features: int, kernel, in_features: int, pad: str = "none",
                 impl: str = "xla", generator=None):
        super().__init__()
        self.kernel, self.pad, self.impl = tuple(kernel), pad, impl
        self.W = nn.Parameter(he_trunc_normal((*self.kernel, in_features, features), generator))
        self.b = nn.Parameter(torch.zeros(features))

    def forward(self, x, plain: bool = False):
        dt = x.dtype
        if self.impl == "pallas" and self.kernel == (3, 3, 3) and self.pad != "none" and not plain:
            y = conv3x3x3(x, self.W, self.pad == "thw")
        elif self.kernel == (1, 1, 1):
            y = x @ self.W[0, 0, 0].to(dt)
        else:
            y = F.conv3d(x.permute(0, 4, 1, 2, 3), self.W.to(dt).permute(4, 3, 0, 1, 2),
                         padding=_PADS[self.pad]).permute(0, 2, 3, 4, 1)
        return y + self.b.to(dt)


def _global_moments(xf, axes, group):
    """Mean and population variance of xf over `axes` and over every rank
    of `group` (equal shapes on every rank), differentiably."""
    from torch.distributed import get_world_size
    from torch.distributed.nn.functional import all_reduce

    count = xf[..., 0].numel() * get_world_size(group)
    mean = all_reduce(xf.sum(axes), group=group) / count
    var = all_reduce((xf - mean).square().sum(axes), group=group) / count
    return mean, var


class RefBatchNorm(nn.Module):
    """The reference's moving-average BN: gamma * (x - mean) * rsqrt(var +
    1e-3) + beta in float32, cast back to x's dtype.

    Training mode takes mean and the population variance (ddof 0, as
    jnp.var) in float32 over every axis but the channel, and gradients flow
    through both.  It then updates the buffers, detached, as TF's
    zero_debias moving averages: biased <- biased * d + stat * (1 - d) with
    d = 0.999, local_step <- local_step + 1, moving = biased / (1 - d^t),
    the power in float32 (pfnl_tpu/models/duf.py:137-159).  Eval mode reads
    moving_mean and moving_variance, which start at 0 as in the reference.

    stats_group: under data-parallel training, the process group of the data
    axis (the Trainer sets it).  The statistics are then those of the global
    batch, as `jnp.mean` / `jnp.var` reduce a batch sharded over the mesh in
    the JAX package: the sum, then the sum of squared deviations from the
    global mean, each all-reduced over the group by a differentiable
    all-reduce, so the output, the gradients and the buffers are the
    single-process step's at the global batch."""

    decay = 0.999

    def __init__(self, features: int):
        super().__init__()
        self.stats_group = None
        self.beta = nn.Parameter(torch.zeros(features))
        self.gamma = nn.Parameter(torch.ones(features))
        for name in ("moving_mean", "moving_variance", "biased_mean", "biased_var"):
            self.register_buffer(name, torch.zeros(features))
        self.register_buffer("local_step", torch.zeros(()))

    def forward(self, x):
        if self.training:
            xf = x.float()
            axes = tuple(range(x.dim() - 1))
            if self.stats_group is None:
                mean, var = xf.mean(axes), xf.var(axes, unbiased=False)
            else:
                mean, var = _global_moments(xf, axes, self.stats_group)
            with torch.no_grad():
                d = self.decay
                self.biased_mean.copy_(self.biased_mean * d + mean * (1 - d))
                self.biased_var.copy_(self.biased_var * d + var * (1 - d))
                self.local_step.add_(1.0)
                debias = 1.0 - torch.pow(torch.full_like(self.local_step, d), self.local_step)
                self.moving_mean.copy_(self.biased_mean / debias)
                self.moving_variance.copy_(self.biased_var / debias)
        else:
            mean, var = self.moving_mean, self.moving_variance
        inv = torch.rsqrt(var + 1e-3)
        return (self.gamma * (x.float() - mean) * inv + self.beta).to(x.dtype)

    def folded(self):
        """The eval affine (scale, offset): s * x + o == BN(x)."""
        s = self.gamma * torch.rsqrt(self.moving_variance + 1e-3)
        return s, self.beta - self.moving_mean * s


class FRNet(nn.Module):
    """The dense 3-D backbone and its two heads (reference model/nets.py).

    conv3d_impl keeps the JAX field's values: "xla" the plain path, "fused"
    kernel 9 for the dense blocks (eval mode only: it folds the moving
    statistics), "pallas" kernel 10 for every padded 3x3x3 conv, "auto"
    kernel 9 on a CUDA tensor in eval mode (JAX: "fused" on the accelerator
    when not `is_train`) when no gradient is being recorded (kernel 9 has
    no backward), and the plain path otherwise: training takes cuDNN's
    F.conv3d, as JAX's training takes XLA.  plain=True takes the plain path
    whatever the field says."""

    def __init__(self, layers: int = 52, scale: int = 4, conv3d_impl: str = "auto",
                 generator=None):
        super().__init__()
        if conv3d_impl not in CONV3D_IMPLS:
            raise ValueError(f"conv3d_impl must be one of {CONV3D_IMPLS}, got {conv3d_impl!r}")
        n_thw, n_hw, growth, conv2_in = FR_CONFIGS[layers]
        self.conv3d_impl, self.r2 = conv3d_impl, scale * scale
        grow_impl = "pallas" if conv3d_impl == "pallas" else "xla"
        self.conv1 = Conv3D(64, (1, 3, 3), 3, "hw", generator=generator)
        self.modes = []
        feats = 64
        for r in range(1, n_thw + n_hw + 1):
            mode = "thw" if r <= n_thw else "hw"
            self.add_module(f"Rbn{r}a", RefBatchNorm(feats))
            self.add_module(f"Rconv{r}a", Conv3D(feats, (1, 1, 1), feats, generator=generator))
            self.add_module(f"Rbn{r}b", RefBatchNorm(feats))
            self.add_module(f"Rconv{r}b", Conv3D(growth, (3, 3, 3), feats, mode, grow_impl,
                                                 generator))
            self.modes.append(mode)
            feats += growth
        self.fbn1 = RefBatchNorm(conv2_in)
        self.conv2 = Conv3D(256, (1, 3, 3), conv2_in, "hw", generator=generator)
        self.rconv1 = Conv3D(256, (1, 1, 1), 256, generator=generator)
        self.rconv2 = Conv3D(3 * self.r2, (1, 1, 1), 256, generator=generator)
        self.fconv1 = Conv3D(512, (1, 1, 1), 256, generator=generator)
        self.fconv2 = Conv3D(25 * self.r2, (1, 1, 1), 512, generator=generator)

    def _block(self, r: int):
        return tuple(getattr(self, f"{k}{r + 1}{s}")
                     for k, s in (("Rbn", "a"), ("Rconv", "a"), ("Rbn", "b"), ("Rconv", "b")))

    def block_params(self):
        """Every dense block with its BatchNorms folded, for kernel 9."""
        blocks = []
        for r, mode in enumerate(self.modes):
            bna, ca, bnb, cb = self._block(r)
            sa, oa = bna.folded()
            sb, ob_bn = bnb.folded()
            f = ca.W.shape[-1]
            blocks.append(BlockParams(sa=sa, oa=oa, wa=ca.W.reshape(f, f), sb=sb,
                                      ob=sb * ca.b + ob_bn, wb=cb.W, bb=cb.b, mode=mode))
        return blocks

    def backbone_impl(self, on_cuda: bool, plain: bool = False) -> str:
        """The conv3d_impl a forward takes now: "auto" resolved by the device,
        the mode and the grad mode (see the class docstring)."""
        if plain:
            return "xla"
        if self.conv3d_impl == "auto":
            return ("fused" if on_cuda and not self.training and not torch.is_grad_enabled()
                    else "xla")
        return self.conv3d_impl

    def features(self, x, plain: bool = False):
        """x [N,T,h,w,3] in the compute dtype -> the backbone's output
        [N,T-6,h,w,C_fin] (conv1 and the dense blocks)."""
        impl = self.backbone_impl(x.is_cuda, plain)
        x = self.conv1(x, plain)
        if impl == "fused":
            if self.training:
                raise NotImplementedError("kernel 9 folds the eval BatchNorms and does not "
                                          "train; train with conv3d_impl auto, pallas or xla")
            return dense_backbone(x, self.block_params())
        for r, mode in enumerate(self.modes):
            bna, ca, bnb, cb = self._block(r)
            t = cb(torch.relu(bnb(ca(torch.relu(bna(x))))), plain)
            x = torch.cat([x if mode == "thw" else x[:, 1:-1], t], -1)
        return x

    def forward(self, x, plain: bool = False):
        """-> (filters [N,1,h,w,25,r*r] float32, softmaxed over the taps;
        residual [N,1,h,w,3*r*r] in the compute dtype)."""
        x = torch.relu(self.fbn1(self.features(x, plain)))
        x = torch.relu(self.conv2(x))
        r = self.rconv2(torch.relu(self.rconv1(x)))
        f = self.fconv2(torch.relu(self.fconv1(x)))
        n, t, h, w, _ = f.shape
        f = torch.softmax(f.float().reshape(n, t, h, w, 25, self.r2), dim=4)
        return f, r


class DUF(nn.Module):
    # read by the Predictor: RGB out; LR padded to an even size as the JAX
    # Predictor pads every window family; testvideos reads blur4/ by default
    # (pfnl_tpu/infer/predictor.py:378-379 degrades truth/ only for PFNL)
    y_channel = False
    lr_multiple = 2
    reads_truth = False
    recurrent = False

    def __init__(self, num_frames: int = 7, scale: int = 4, layers: int = 52,
                 conv3d_impl: str = "auto", dtype: torch.dtype = torch.float32,
                 generator: torch.Generator = None):
        """dtype: compute dtype of the backbone and heads (float32 or
        bfloat16); parameters stay float32.  generator: the source of the
        he-truncated-normal init."""
        super().__init__()
        self.num_frames, self.scale, self.layers, self.dtype = num_frames, scale, layers, dtype
        self.G = FRNet(layers, scale, conv3d_impl, generator)

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """x [N,T,h,w,3] -> SR [N,1,4h,4w,3] float32; plain=True runs the
        plain PyTorch path (the reference the kernels are checked against
        on the card)."""
        n, t, h, w, _ = x.shape
        if t != self.num_frames:
            raise ValueError(f"expected {self.num_frames} frames, got {t}")
        fx, rx = self.G(x.to(self.dtype), plain=plain)
        centre = x.float()[:, t // 2:t // 2 + 1]
        chans = [depth_to_space(dyn_filter_3d(centre[..., c], fx[:, 0]), self.scale)
                 for c in range(3)]
        sr = torch.cat(chans, dim=3)[:, None]
        return sr + depth_to_space_3d(rx.float(), self.scale)
