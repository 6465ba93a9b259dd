"""Flow-estimation subnetworks (counterpart: pfnl_tpu/models/flows.py,
its plain branches; the `packed` layouts there are TPU rewrites of the
same functions).

  EasyFlow  coarse (x4 sub-pixel) + refinement (x2 sub-pixel) flow net of
            VESPCN, MCResNet and DRVSR (reference
            modules/model_easyflow.py:64-106); |flow| < 2
  LTDFlow   LTDVSR's pooled flow net (model/ltdvsr.py:136-149); |flow| < 1
  FRVSRFlow FRVSR's 3-level conv U-net (model/frvsr.py:68-96); |flow| < 1

Each takes a pair of [N,h,w,C] images and returns flow [N,h,w,2] (x = col,
y = row) in the compute dtype.  Parameter names are flax's
(`c1..c5, s1..s5`; `conv0..conv2`; `conv0_{p}_{q}, conv1_{p}_{q}, conv2,
conv3`).  `y_and_pairs` and `splat` are the
Y families' shared head and motion compensation.
"""

import torch
import torch.nn.functional as F
from torch import nn

from pfnl_tpu_torch.models.blocks import Conv, leaky_relu
from pfnl_tpu_torch.ops.color import rgb2y
from pfnl_tpu_torch.ops.resize import resize_bilinear
from pfnl_tpu_torch.ops.warp import (backward_warp_local, forward_warp_local,
                                     forward_warp_local_ref)


def _subpixel_flow(x: torch.Tensor, r: int) -> torch.Tensor:
    """[n,h/r,w/r,2*r*r] -> [n,h,w,2]: channel (uv, dy, dx) in that
    order, as the reference reshapes it (model_easyflow.py:87-89)."""
    n, hh, ww, _ = x.shape
    x = x.reshape(n, hh, ww, 2, r, r).permute(0, 1, 4, 2, 5, 3)
    return x.reshape(n, hh * r, ww * r, 2)


def _max_pool2(x: torch.Tensor) -> torch.Tensor:
    """2x2 max-pool at stride 2 on [N,h,w,C], VALID: an odd size floors, as
    flax's nn.max_pool does."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)


class EasyFlow(nn.Module):
    def __init__(self, channels: int = 1, dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        c = channels
        self.dtype = dtype
        for name, k, ci, co in (("c1", 5, 2 * c, 24), ("c2", 3, 24, 24), ("c3", 5, 24, 24),
                                ("c4", 3, 24, 24), ("c5", 3, 24, 32), ("s1", 5, 2 * c + 3, 24),
                                ("s2", 3, 24, 24), ("s3", 3, 24, 24), ("s4", 3, 24, 24),
                                ("s5", 3, 24, 8)):
            setattr(self, name, Conv((k, k, ci, co), generator))

    def forward(self, imga, imgb):
        """imga, imgb [N,h,w,C] (h, w multiples of 4) -> flow [N,h,w,2]."""
        inputs = torch.cat([imga, imgb], -1).to(self.dtype)
        c1 = torch.relu(self.c1(inputs, stride=2))
        c2 = torch.relu(self.c2(c1))
        c3 = torch.relu(self.c3(c2, stride=2))
        c4 = torch.relu(self.c4(c3))
        c5_hr = _subpixel_flow(torch.tanh(self.c5(c4)), 4)
        # the coarse flow is tanh-bounded (|uv| < 1): the local gather warp
        img_warp = backward_warp_local(imgb, c5_hr, max_disp=1)
        pack = torch.cat([inputs, c5_hr, img_warp.to(self.dtype)], -1)
        s1 = torch.relu(self.s1(pack, stride=2))
        s2 = torch.relu(self.s2(s1))
        s3 = torch.relu(self.s3(s2))
        s4 = torch.relu(self.s4(s3))
        s5_hr = _subpixel_flow(torch.tanh(self.s5(s4)), 2)
        return c5_hr + s5_hr


class LTDFlow(nn.Module):
    def __init__(self, channels: int = 1, dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.conv0 = Conv((9, 9, 2 * channels, 32), generator)
        self.conv1 = Conv((9, 9, 32, 32), generator)
        self.conv2 = Conv((3, 3, 32, 2), generator)

    def forward(self, source, reference):
        """source, reference [N,h,w,C] (h, w multiples of 4) -> flow
        [N,h,w,2]: two 9x9 convs with 2x2 max-pools, a bilinear resize
        back to (h, w), a 3x3 conv and tanh."""
        n, h, w, _ = reference.shape
        x = torch.cat([reference, source], -1).to(self.dtype)
        for conv in (self.conv0, self.conv1):
            x = torch.relu(conv(x))
            x = _max_pool2(x)
        x = resize_bilinear(x, (h, w))
        return torch.tanh(self.conv2(x))


class FRVSRFlow(nn.Module):
    def __init__(self, channels: int = 3, dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        cin = 2 * channels
        for p in range(3):
            for q in range(2):
                f = 32 * 2 ** p
                setattr(self, f"conv0_{p}_{q}", Conv((3, 3, cin, f), generator))
                cin = f
        for p in range(3):
            for q in range(2):
                f = 256 // 2 ** p
                setattr(self, f"conv1_{p}_{q}", Conv((3, 3, cin, f), generator))
                cin = f
        self.conv2 = Conv((3, 3, cin, 32), generator)
        self.conv3 = Conv((3, 3, 32, 2), generator)

    def forward(self, i_t, i_pt):
        """i_t, i_pt [N,h,w,C] -> flow [N,h,w,2] in [-1, 1]: three levels of
        two 3x3 convs (leaky ReLU 0.2) and a 2x2 max-pool, three decoder
        levels each ending in a bilinear resize to twice the pooled size,
        then a resize to (h, w) where the pools floored (180 -> 22 -> 176),
        a conv and tanh(conv)."""
        _, h, w, _ = i_t.shape
        x = torch.cat([i_t, i_pt], -1).to(self.dtype)
        for p in range(3):
            for q in range(2):
                x = leaky_relu(getattr(self, f"conv0_{p}_{q}")(x))
            x = _max_pool2(x)
        h1, w1 = x.shape[1], x.shape[2]
        for p in range(3):
            for q in range(2):
                x = leaky_relu(getattr(self, f"conv1_{p}_{q}")(x))
            x = resize_bilinear(x, (h1 * 2 ** (p + 1), w1 * 2 ** (p + 1)))
        if x.shape[1] != h or x.shape[2] != w:
            x = resize_bilinear(x, (h, w))
        x = leaky_relu(self.conv2(x))
        return torch.tanh(self.conv3(x))


class YFamily(nn.Module):
    """What the Predictor reads of a Y-channel family: it serves through
    `serve_rgb` (the SR Y of the last output frame, the bicubic CbCr of the
    centre frame), pads LR frames to a multiple of 4 (the flow nets' two
    stride-2 stages or pools), `testvideos` reads blur{scale}/ unless told
    otherwise, and it runs in window batches (not recurrent).
    serve_kwargs: extra arguments of the serving forward."""
    y_channel = True
    lr_multiple = 4
    reads_truth = False
    recurrent = False
    serve_kwargs = {}


def y_and_pairs(frames_lr: torch.Tensor, dtype):
    """The Y families' common head: frames_y [N,T,h,w,1] in `dtype`, the
    centre frame ref_y [N,h,w,1], and the flow net's pairs as two
    [N*T,h,w,1] batches (every frame, the centre frame repeated)."""
    n, t, h, w, _ = frames_lr.shape
    frames_y = rgb2y(frames_lr.to(dtype))
    ref_y = frames_y[:, t // 2]
    flat = frames_y.reshape(n * t, h, w, 1)
    ref_rep = ref_y[:, None].expand(n, t, h, w, 1).reshape(n * t, h, w, 1)
    return frames_y, ref_y, flat, ref_rep


def splat(flat: torch.Tensor, uv: torch.Tensor, max_disp: int, plain: bool) -> torch.Tensor:
    """The bounded splat: kernel 7 on a CUDA tensor unless plain=True asks
    for its plain version (the reference the kernel path is held to)."""
    fn = forward_warp_local_ref if plain else forward_warp_local
    return fn(flat.contiguous(), uv.contiguous(), max_disp)
