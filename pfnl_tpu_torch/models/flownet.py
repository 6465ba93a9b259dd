"""FlowNet-S, FlowNet-C and the warp-confidence net (counterpart:
pfnl_tpu/models/flownet.py; reference modules/model_flownet.py:10-335).

They are dormant in the reference's training paths (imported, never built;
only EasyFlow is used) and are here so that the port covers what the JAX
package offers:

  * the shared pre and post processing (model_flownet.py:23-31,79-81):
    per-image mean subtraction, a bilinear align_corners resize to the next
    multiple of 64, and the x20 flow resized back with per-axis rescale
    coefficients;
  * 6-level encoders whose strided convs are the reference's `stride-1 conv
    then [:, 0::2, 0::2]`: a stride-2 conv padded k//2 on every side, not
    TF-SAME's asymmetric stride-2 pads (so not ops/conv.conv2d_same);
  * the refinement decoder with its flow heads flow6..flow2, whose
    transposed convs are flax ConvTranspose k=4 s=2 SAME
    (ops/conv.conv_transpose_same2);
  * FlowNet-C's correlation layer (model_flownet.py:217-240), plain PyTorch
    as it is XLA in the JAX package, and the warp-confidence net `uv_conf`
    (model_flownet.py:84-113).

The activation is leaky_relu with slope 0.1.  The JAX package fixes two
latent bugs of the reference's FLOWNETC.forward (dead code there); so does
the port: the pair runs through one siamese encoder, and concat2 follows
FlowNet-S.  Parameters keep flax's names and layouts (`conv1.kernel` HWIO,
`decoder.deconv5.kernel` [kh,kw,in,out], `bn1.scale`), float32, cast to the
activation dtype at use; WarpConfidence's BatchNorm statistics (`bn1.mean`,
`bn1.var`) are buffers.  Caffe weights: utils/param_io.load_caffe_flownet.
"""

import torch
import torch.nn.functional as F
from torch import nn

from pfnl_tpu_torch.models.blocks import ConvParams, conv_lecun, leaky_relu
from pfnl_tpu_torch.ops.conv import conv2d_same, conv_transpose_same2
from pfnl_tpu_torch.ops.resize import resize_bilinear


def _act(x):
    """leaky_relu, slope 0.1 (videosr_ops.py:40; model_flownet.py:33-36)."""
    return leaky_relu(x, 0.1)


class _Conv(ConvParams):
    """flax nn.Conv, lecun-normal kernel: SAME at stride 1, or at stride 2
    padded k//2 on every side, so output pixel i is centred on input pixel
    2i (the reference's stride-1 conv sampled [:, 0::2, 0::2])."""

    def __init__(self, k, cin, cout, generator=None):
        super().__init__((k, k, cin, cout), generator, init=conv_lecun)

    def forward(self, x, stride: int = 1):
        if stride == 1:
            y = conv2d_same(x, self.kernel)
        else:
            p = self.kernel.shape[0] // 2
            y = F.conv2d(x.permute(0, 3, 1, 2), self.kernel.to(x.dtype).permute(3, 2, 0, 1),
                         stride=stride, padding=p).permute(0, 2, 3, 1)
        return y + self.bias.to(x.dtype)


class _Deconv(ConvParams):
    """flax nn.ConvTranspose, 4x4, stride 2, SAME: [N,h,w,Ci] -> [N,2h,2w,Co]."""

    def __init__(self, cin, cout, generator=None):
        super().__init__((4, 4, cin, cout), generator, init=conv_lecun)

    def forward(self, x):
        return conv_transpose_same2(x, self.kernel) + self.bias.to(x.dtype)


def _adapt(x):
    """Mean-subtract each image and resize it to the next multiple of 64
    (model_flownet.py:23-31).  Returns (adapted, (sx, sy)), the per-axis
    rescale coefficients of the final flow."""
    n, h, w, c = x.shape
    ah, aw = -(-h // 64) * 64, -(-w // 64) * 64
    x = x - x.mean(dim=(1, 2), keepdim=True)
    if (ah, aw) != (h, w):
        x = resize_bilinear(x, (ah, aw), mapping="align_corners")
    return x, (w / aw, h / ah)


def _unadapt(flow2, h, w, scale_xy, flow_scale):
    """x flow_scale, align_corners resize to the caller's size, and the
    per-axis rescale (model_flownet.py:78-81)."""
    flow = flow2 * flow_scale
    if tuple(flow.shape[1:3]) != (h, w):
        flow = resize_bilinear(flow, (h, w), mapping="align_corners")
    return flow * torch.tensor(scale_xy, dtype=flow.dtype, device=flow.device)


class _Decoder(nn.Module):
    """The refinement decoder (model_flownet.py:50-78), shared by FlowNet-S
    and -C from conv3_1 up."""

    def __init__(self, c2: int = 128, c3: int = 256, generator=None):
        super().__init__()
        cat5, cat4 = 512 + 512 + 2, 512 + 256 + 2
        cat3, cat2 = c3 + 128 + 2, c2 + 64 + 2
        for i, cin, cup in ((6, 1024, 512), (5, cat5, 256), (4, cat4, 128), (3, cat3, 64)):
            setattr(self, f"predict_flow{i}", _Conv(3, cin, 2, generator))
            setattr(self, f"deconv{i - 1}", _Deconv(cin, cup, generator))
            setattr(self, f"upsample_flow{i}", _Deconv(2, 2, generator))
        self.predict_flow2 = _Conv(3, cat2, 2, generator)

    def forward(self, c2, c3_1, c4_1, c5_1, c6_1):
        cat = c6_1
        for i, skip in ((6, c5_1), (5, c4_1), (4, c3_1), (3, c2)):
            flow = getattr(self, f"predict_flow{i}")(cat)
            up = _act(getattr(self, f"deconv{i - 1}")(cat))
            cat = torch.cat([skip, up, getattr(self, f"upsample_flow{i}")(flow)], -1)
        return self.predict_flow2(cat)


class _Trunk(nn.Module):
    """conv4 .. conv6_1, the encoder levels after conv3_1."""

    def __init__(self, generator=None):
        super().__init__()
        self.conv4 = _Conv(3, 256, 512, generator)
        self.conv4_1 = _Conv(3, 512, 512, generator)
        self.conv5 = _Conv(3, 512, 512, generator)
        self.conv5_1 = _Conv(3, 512, 512, generator)
        self.conv6 = _Conv(3, 512, 1024, generator)
        self.conv6_1 = _Conv(3, 1024, 1024, generator)

    def levels(self, c3_1):
        c4_1 = _act(self.conv4_1(_act(self.conv4(c3_1, 2))))
        c5_1 = _act(self.conv5_1(_act(self.conv5(c4_1, 2))))
        c6_1 = _act(self.conv6_1(_act(self.conv6(c5_1, 2))))
        return c4_1, c5_1, c6_1


class FlowNetS(_Trunk):
    """FlowNet-Simple (model_flownet.py:21-82): the 6-level encoder over the
    channel-concatenated pair, the refinement decoder, and the x20 flow at
    the input's size.  img0, img1 [N,H,W,3] -> flow [N,H,W,2]."""

    def __init__(self, flow_scale: float = 20.0, generator=None):
        super().__init__(generator)
        self.flow_scale = flow_scale
        self.conv1 = _Conv(7, 6, 64, generator)
        self.conv2 = _Conv(5, 64, 128, generator)
        self.conv3 = _Conv(5, 128, 256, generator)
        self.conv3_1 = _Conv(3, 256, 256, generator)
        self.decoder = _Decoder(generator=generator)

    def forward(self, img0, img1):
        n, h, w, _ = img0.shape
        x, scale_xy = _adapt(torch.cat([img0, img1], -1))
        c2 = _act(self.conv2(_act(self.conv1(x, 2)), 2))
        c3_1 = _act(self.conv3_1(_act(self.conv3(c2, 2))))
        flow2 = self.decoder(c2, c3_1, *self.levels(c3_1))
        return _unadapt(flow2, h, w, scale_xy, self.flow_scale)


def correlation(a: torch.Tensor, b: torch.Tensor, max_disp: int = 20,
                stride: int = 2) -> torch.Tensor:
    """FlowNet-C's correlation layer (model_flownet.py:217-240): for every
    displacement (dy, dx) in {-max_disp, ..., max_disp} step `stride`, the
    channel sum of a * (b shifted, zero outside), divided by the number of
    displacements (441 at the reference's max_disp 20 / stride 2).
    a, b [N,H,W,C] -> [N,H,W,nd*nd], dy major."""
    n, h, w, c = a.shape
    d = max_disp
    nd = len(range(-d, d + stride, stride))
    pads = F.pad(b, (0, 0, d, d, d, d))
    outs = [torch.einsum("nhwc,nhwc->nhw", a, pads[:, dy:dy + h, dx:dx + w])
            for dy in range(0, 2 * d + stride, stride)
            for dx in range(0, 2 * d + stride, stride)]
    return torch.stack(outs, -1) / (nd * nd)


class FlowNetC(_Trunk):
    """FlowNet-Correlation (model_flownet.py:242-313): a siamese 3-level
    encoder (shared weights), the correlation layer and a 1x1 redirect
    conv, then conv3_1 .. conv6_1 and the FlowNet-S decoder.
    img0, img1 [N,H,W,3] -> flow [N,H,W,2]."""

    def __init__(self, flow_scale: float = 20.0, max_disp: int = 20, generator=None):
        super().__init__(generator)
        self.flow_scale, self.max_disp = flow_scale, max_disp
        nd = len(range(-max_disp, max_disp + 2, 2))
        self.conv1 = _Conv(7, 3, 64, generator)
        self.conv2 = _Conv(5, 64, 128, generator)
        self.conv3 = _Conv(5, 128, 256, generator)
        self.conv_redir = _Conv(1, 256, 32, generator)
        self.conv3_1 = _Conv(3, 32 + nd * nd, 256, generator)
        self.decoder = _Decoder(generator=generator)

    def forward(self, img0, img1):
        n, h, w, c = img0.shape
        x, scale_xy = _adapt(torch.cat([img0, img1], -1))
        # the pair stacked on the batch: one pass of the shared encoder
        pair = torch.cat([x[..., :c], x[..., c:]], 0)
        c2 = _act(self.conv2(_act(self.conv1(pair, 2)), 2))
        f = _act(self.conv3(c2, 2))
        c2a, fa, fb = c2[:n], f[:n], f[n:]
        corr = correlation(fa, fb, self.max_disp, 2)
        redir = _act(self.conv_redir(fa))
        c3_1 = _act(self.conv3_1(torch.cat([redir, corr], -1)))
        flow2 = self.decoder(c2a, c3_1, *self.levels(c3_1))
        return _unadapt(flow2, h, w, scale_xy, self.flow_scale)


class BatchNorm(nn.Module):
    """flax nn.BatchNorm(momentum=0.9, epsilon=1e-3) over the last axis, by
    hand: torch's BatchNorm weighs its running update the other way round
    and keeps the unbiased running variance.  Training mode normalises by
    the batch's mean and its variance mean(x^2) - mean(x)^2 (clipped at 0,
    flax's fast variance), both float32, and updates the buffers
    stat <- 0.9 stat + 0.1 batch (`mean` from 0, `var` from 1); eval mode
    reads the buffers."""

    def __init__(self, features: int, momentum: float = 0.9, eps: float = 1e-3):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, x):
        if self.training:
            xf = x.float()
            axes = tuple(range(x.dim() - 1))
            mean = xf.mean(axes)
            var = torch.clamp((xf * xf).mean(axes) - mean * mean, min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.mean.copy_(m * self.mean + (1 - m) * mean)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mean, var = self.mean, self.var
        y = (x - mean) * (torch.rsqrt(var + self.eps) * self.scale)
        return (y + self.bias).to(x.dtype)


class WarpConfidence(nn.Module):
    """`uv_conf`, the warp-confidence net (model_flownet.py:84-113): both
    images contrast-normalised (mean removed, then divided by mean(x^2),
    with no square root, as the reference does), a single channel tiled to
    three, a shared stack of nine 5x5 convs each followed by a BatchNorm
    (and relu but for the last), and the channels' cosine similarity mapped
    to [0, 1].  a, b [N,H,W,C] (b already warped) -> [N,H,W,1].  Training
    mode (torch's default) is flax's train=True: batch statistics, buffers
    updated; `.eval()` reads the running statistics, flax's default."""

    WIDTHS = (32, 32, 64, 64, 64, 64, 64, 64, 64)

    def __init__(self, generator=None):
        super().__init__()
        cin = 3
        for i, wdt in enumerate(self.WIDTHS, 1):
            setattr(self, f"conv{i}", _Conv(5, cin, wdt, generator))
            setattr(self, f"bn{i}", BatchNorm(wdt))
            cin = wdt

    def forward(self, a, b):
        x = torch.cat([a, b], 0)
        x = x - x.mean(dim=(1, 2), keepdim=True)
        x = x / (x * x).mean(dim=(1, 2), keepdim=True)
        if x.shape[-1] == 1:
            x = x.expand(-1, -1, -1, 3)
        for i in range(1, len(self.WIDTHS) + 1):
            x = getattr(self, f"bn{i}")(getattr(self, f"conv{i}")(x))
            if i < len(self.WIDTHS):
                x = torch.relu(x)
        na, nb = x[:a.shape[0]], x[a.shape[0]:]

        def norm(v):
            return v * torch.rsqrt((v * v).sum(-1, keepdim=True) + 1e-12)

        cos = (norm(na) * norm(nb)).sum(-1, keepdim=True)
        return (cos + 1.0) / 2.0
