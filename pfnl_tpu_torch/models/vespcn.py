"""VESPCN: Real-Time Video SR with Spatio-Temporal Networks and Motion
Compensation — counterpart of pfnl_tpu/models/vespcn.py (plain trunk;
reference model/vespcn.py:30-106).

  x [N,T,h,w,3] -> Y -> EasyFlow of every frame against the centre frame
    -> bounded forward splat of each Y frame (kernel 7 on the GPU, R=2)
    -> concat [N,h,w,T] -> 5x5@24 + 9x(3x3@24) + 3x3@16, PReLU each
    -> _PS x2 -> 3x3 4->4 -> _PS x2 -> + bicubic(centre Y)
    -> sr [N,1,4h,4w,1] float32

Returns the JAX model's dict: sr, uv [N,T,h,w,2], frames_y, ref_y (the
flow loss reads the last three).  h and w must be multiples of 4
(EasyFlow); the Predictor pads.
"""

import torch

from pfnl_tpu_torch.models.blocks import Conv, PReLU
from pfnl_tpu_torch.models.flows import EasyFlow, YFamily, splat, y_and_pairs
from pfnl_tpu_torch.ops.resize import resize_bicubic
from pfnl_tpu_torch.ops.shuffle import pixel_shuffle_legacy


class VESPCN(YFamily):

    def __init__(self, num_frames: int = 3, scale: int = 4, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator = None):
        super().__init__()
        self.num_frames, self.scale, self.dtype = num_frames, scale, dtype
        self.easyflow = EasyFlow(1, dtype, generator)
        self.enc1 = Conv((5, 5, num_frames, 24), generator)
        for i in range(9):
            setattr(self, f"enc2_{i}", Conv((3, 3, 24, 24), generator))
        self.conv6 = Conv((3, 3, 24, 16), generator)
        self.rnn_out = Conv((3, 3, 4, 4), generator)
        # flax declares a 12th PReLU it never calls, so its tree has 11
        for i, c in enumerate([24] * 10 + [16]):
            setattr(self, f"prelu_{i}", PReLU(c))

    def forward(self, frames_lr: torch.Tensor, plain: bool = False, row0: int = 0) -> dict:
        """row0: the row of the whole image that is the first of frames_lr (a
        band of parallel/spmd.sharded_forward: the warps round their
        coordinates as the whole image's, `ops.warp.band_flow`)."""
        n, t, h, w, _ = frames_lr.shape
        frames_y, ref_y, flat, ref_rep = y_and_pairs(frames_lr, self.dtype)
        bic_ref = resize_bicubic(ref_y, (h * self.scale, w * self.scale))
        uv = self.easyflow(flat, ref_rep, row0)
        # EasyFlow is two tanh stages, so |uv| < 2
        warped = splat(flat, uv, 2, plain, row0)
        x = warped.reshape(n, t, h, w, 1).permute(0, 2, 3, 1, 4).reshape(n, h, w, t)
        x = self.prelu_0(self.enc1(x))
        for i in range(9):
            x = getattr(self, f"prelu_{i + 1}")(getattr(self, f"enc2_{i}")(x))
        x = self.prelu_10(self.conv6(x))
        x = pixel_shuffle_legacy(x, 2, 4)
        x = self.rnn_out(x)  # no activation (model/vespcn.py:98)
        x = pixel_shuffle_legacy(x, 2, 1)
        sr = (x + bic_ref).float()
        return {"sr": sr[:, None], "uv": uv.reshape(n, t, h, w, 2), "frames_y": frames_y,
                "ref_y": ref_y}
