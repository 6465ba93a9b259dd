"""DRVSR: Detail-revealing Deep Video Super-Resolution — counterpart of
pfnl_tpu/models/drvsr.py (plain step; reference model/drvsr.py:25-189).

  x [N,T,h,w,3] -> Y -> EasyFlow against the centre frame (|uv| < 2)
    -> SPMC: each Y frame splatted straight onto the x4 grid (kernel 8 on
       the GPU), [N,T,4h,4w,1]
    -> per frame, `srmodel`: 5x5@32, two stride-2 encoder stages to 1/4 of
       the HR grid, a ConvLSTM at 128 channels, a decoder of k=4 stride-2
       transposed convs with skip adds, 5x5 32->1
    -> + bicubic(centre Y) -> sr [N,T,4h,4w,1] float32

`last_only=True` is the serving form: the reference saves only the last
frame's decode (model/drvsr.py:505), so frames 0..T-2 run the encoder and
the LSTM only and one decode follows, sr [N,1,4h,4w,1].  It also skips
`warped_lr`, the LR-grid splat the flow loss reads: the JAX serving
function reads only `sr`, so under `jax.jit` that splat is dead code too.
"""

import torch
from torch import nn

from pfnl_tpu_torch.models.blocks import Conv, ConvParams
from pfnl_tpu_torch.models.flows import EasyFlow, YFamily, splat, y_and_pairs
from pfnl_tpu_torch.ops.conv import conv_transpose_same2
from pfnl_tpu_torch.ops.convlstm import ConvLSTMCell
from pfnl_tpu_torch.ops.resize import resize_bicubic
from pfnl_tpu_torch.ops.warp import band_flow, forward_warp_local_spmc, forward_warp_spmc

LSTM_FEATURES = 128


class SRStep(nn.Module):
    """One encoder / ConvLSTM / decoder step over one HR-warped frame
    (pfnl_tpu drvsr.py `_SRStep`, flax name `srmodel`)."""

    def __init__(self, dtype: torch.dtype = torch.float32, generator=None):
        super().__init__()
        self.dtype = dtype
        self.enc1 = Conv((5, 5, 1, 32), generator)
        self.enc2 = Conv((3, 3, 32, 64), generator)
        self.enc2_1 = Conv((3, 3, 64, 64), generator)
        self.enc3 = Conv((3, 3, 64, 128), generator)
        self.lstm = ConvLSTMCell(128, LSTM_FEATURES, 3, generator=generator)
        self.enc3_1 = Conv((3, 3, 128, 128), generator)
        self.dec1 = ConvParams((4, 4, 128, 64), generator)
        self.dec1_1 = Conv((3, 3, 64, 64), generator)
        self.dec2 = ConvParams((4, 4, 64, 32), generator)
        self.dec2_1 = Conv((3, 3, 32, 32), generator)
        self.dec3 = Conv((5, 5, 32, 1), generator)

    def _deconv(self, x, p):
        return conv_transpose_same2(x, p.kernel) + p.bias.to(x.dtype)

    def forward(self, state, x, decode: bool = True):
        """state (c, h) [N,H/4,W/4,128]; x [N,H,W,1] -> (state', out
        [N,H,W,1] or None without decode)."""
        x = x.to(self.dtype)
        conv1 = torch.relu(self.enc1(x))
        conv2 = torch.relu(self.enc2(conv1, stride=2))
        conv2_1 = torch.relu(self.enc2_1(conv2))
        conv3 = torch.relu(self.enc3(conv2_1, stride=2))
        state, y1 = self.lstm(state, conv3)
        if not decode:
            return state, None
        conv3_1 = torch.relu(self.enc3_1(y1))
        dec1 = torch.relu(self._deconv(conv3_1, self.dec1))
        dec1_1 = torch.relu(self.dec1_1(dec1 + conv2_1))
        dec2 = torch.relu(self._deconv(dec1_1, self.dec2))
        dec2_1 = torch.relu(self.dec2_1(dec2 + conv1))
        return state, self.dec3(dec2_1)  # no activation


class DRVSR(YFamily):
    serve_kwargs = {"last_only": True}

    def __init__(self, num_frames: int = 3, scale: int = 4, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator = None):
        super().__init__()
        self.num_frames, self.scale, self.dtype = num_frames, scale, dtype
        self.easyflow = EasyFlow(1, dtype, generator)
        self.srmodel = SRStep(dtype, generator)

    def forward(self, frames_lr: torch.Tensor, last_only: bool = False,
                plain: bool = False, warped_lr: bool = True, row0: int = 0) -> dict:
        """On a CUDA tensor the SPMC splat is kernel 8 (and the full form's
        `warped_lr` kernel 7) unless plain=True asks for their plain
        versions.  A band of parallel/spmd.sharded_forward passes
        warped_lr=False, which leaves the full form's `warped_lr` out (the
        band reads only sr), and row0, the row of the whole image that is
        its first (the warps round their coordinates as the whole image's,
        `ops.warp.band_flow`)."""
        n, t, h, w, _ = frames_lr.shape
        s = self.scale
        out_h, out_w = h * s, w * s
        frames_y, ref_y, flat, ref_rep = y_and_pairs(frames_lr, self.dtype)
        bic_ref = resize_bicubic(ref_y, (out_h, out_w))
        uv = self.easyflow(flat, ref_rep, row0)
        spmc = forward_warp_local_spmc if plain else forward_warp_spmc
        warped_hr = spmc(flat.contiguous(), band_flow(uv, row0).contiguous(), s, 2).reshape(n, t, out_h, out_w, 1)

        state = self.srmodel.lstm.zero_state(n, out_h // 4, out_w // 4, self.dtype,
                                             frames_lr.device)
        out = {"uv": uv.reshape(n, t, h, w, 2), "frames_y": frames_y, "ref_y": ref_y}
        if last_only:
            # no warped_lr here: serving reads only sr (see the module docstring)
            for i in range(t - 1):
                state, _ = self.srmodel(state, warped_hr[:, i], decode=False)
            _, last = self.srmodel(state, warped_hr[:, t - 1])
            outs = last[:, None]
        else:
            if warped_lr:
                out["warped_lr"] = splat(flat, uv, 2, plain).reshape(n, t, h, w, 1).float()
            steps = []
            for i in range(t):
                state, o = self.srmodel(state, warped_hr[:, i])
                steps.append(o)
            outs = torch.stack(steps, 1)
        out["sr"] = (outs + bic_ref[:, None]).float()
        return out
