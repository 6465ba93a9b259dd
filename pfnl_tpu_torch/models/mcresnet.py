"""MCResNet: EasyFlow motion compensation + a deep residual CNN —
counterpart of pfnl_tpu/models/mcresnet.py (plain trunk; reference
model/mcresnet.py:30-118).

Two reference quirks are kept:
  * the per-frame 5x5@64 encoders share weights by temporal distance
    |i - centre| (enc1_0 centre, enc1_1 the +-1 frames, enc1_2 the +-2);
  * every trunk conv reads `merge`, and `merge` accumulates the conv
    outputs from the second conv on; the head reads the last conv's output.

Bounded forward splat of the Y frames by kernel 7 on the GPU (R=2).
Returns sr [N,1,4h,4w,1] float32, uv, frames_y, ref_y.
"""

import torch

from pfnl_tpu_torch.models.blocks import Conv, PReLU
from pfnl_tpu_torch.models.flows import EasyFlow, YFamily, splat, y_and_pairs
from pfnl_tpu_torch.ops.resize import resize_bicubic
from pfnl_tpu_torch.ops.shuffle import pixel_shuffle_legacy


class MCResNet(YFamily):

    def __init__(self, num_frames: int = 5, scale: int = 4, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator = None):
        super().__init__()
        self.num_frames, self.scale, self.dtype = num_frames, scale, dtype
        self.easyflow = EasyFlow(1, dtype, generator)
        for d in range(num_frames // 2 + 1):
            setattr(self, f"enc1_{d}", Conv((5, 5, 1, 64), generator))
        for i in range(num_frames):
            setattr(self, f"enc1_prelu_{i}", PReLU(64))
        for i, ci in enumerate([64 * num_frames] + [32] * 8):
            setattr(self, f"enc2_{i}", Conv((3, 3, ci, 32), generator))
            setattr(self, f"enc2_prelu_{i}", PReLU(32))
        self.conv6 = Conv((3, 3, 32, 16), generator)
        self.conv6_prelu = PReLU(16)
        self.rnn_out = Conv((3, 3, 4, 4), generator)

    def forward(self, frames_lr: torch.Tensor, plain: bool = False, row0: int = 0) -> dict:
        """row0: the row of the whole image that is the first of frames_lr (a
        band of parallel/spmd.sharded_forward: the warps round their
        coordinates as the whole image's, `ops.warp.band_flow`)."""
        n, t, h, w, _ = frames_lr.shape
        idx0 = t // 2
        frames_y, ref_y, flat, ref_rep = y_and_pairs(frames_lr, self.dtype)
        bic_ref = resize_bicubic(ref_y, (h * self.scale, w * self.scale))
        uv = self.easyflow(flat, ref_rep, row0)
        warped = splat(flat, uv, 2, plain, row0).reshape(n, t, h, w, 1)
        enc = [getattr(self, f"enc1_prelu_{i}")(
                   getattr(self, f"enc1_{abs(i - idx0)}")(warped[:, i])) for i in range(t)]
        merge = torch.cat(enc, -1)
        conv2 = merge
        for i in range(9):
            conv2 = getattr(self, f"enc2_prelu_{i}")(getattr(self, f"enc2_{i}")(merge))
            merge = conv2 if i == 0 else merge + conv2
        x = self.conv6_prelu(self.conv6(conv2))
        x = pixel_shuffle_legacy(x, 2, 4)
        x = self.rnn_out(x)
        x = pixel_shuffle_legacy(x, 2, 1)
        sr = (x + bic_ref).float()
        return {"sr": sr[:, None], "uv": uv.reshape(n, t, h, w, 2), "frames_y": frames_y,
                "ref_y": ref_y}
