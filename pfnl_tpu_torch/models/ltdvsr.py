"""RVSR-LTD: Robust Video SR with Learned Temporal Dynamics — counterpart
of pfnl_tpu/models/ltdvsr.py (plain temporal net; reference
model/ltdvsr.py:31-149).

  x [N,5,h,w,3] -> Y -> LTDFlow against the centre frame (|uv| < 1)
    -> bounded forward splat of each Y frame (kernel 7 on the GPU, R=1)
    -> three branches over the centre 1, 3 and 5 warped frames, each
       5x5@64, 3x3@64, 3x3@64, 3x3@16, then depth_to_space(4)
    -> temporal weights: 5x5 convs 5->32->16->3 over the bilinear-upscaled
       raw Y frames, softmax over the three
    -> the weighted sum (no bicubic residual) -> sr [N,1,4h,4w,1] float32

Branch convs keep flax's names `conv{b}_{0,1,3,2}` (in that order of use).
"""

import torch

from pfnl_tpu_torch.models.blocks import Conv
from pfnl_tpu_torch.models.flows import LTDFlow, YFamily, splat, y_and_pairs
from pfnl_tpu_torch.ops.resize import resize_bilinear
from pfnl_tpu_torch.ops.shuffle import depth_to_space

BRANCH_FRAMES = (1, 3, 5)


class LTDVSR(YFamily):

    def __init__(self, num_frames: int = 5, scale: int = 4, dtype: torch.dtype = torch.float32,
                 generator: torch.Generator = None):
        super().__init__()
        if num_frames < 5:
            raise ValueError(f"LTDVSR's widest branch takes 5 frames, got num_frames={num_frames}")
        self.num_frames, self.scale, self.dtype = num_frames, scale, dtype
        self.flow = LTDFlow(1, dtype, generator)
        for b, cin in enumerate(BRANCH_FRAMES):
            for i, (k, ci, co) in zip((0, 1, 3, 2), ((5, cin, 64), (3, 64, 64), (3, 64, 64),
                                                    (3, 64, scale * scale))):
                setattr(self, f"conv{b}_{i}", Conv((k, k, ci, co), generator))
        self.tem0 = Conv((5, 5, num_frames, 32), generator)
        self.tem1 = Conv((5, 5, 32, 16), generator)
        self.tem2 = Conv((5, 5, 16, 3), generator)

    def _branch(self, b: int, x: torch.Tensor) -> torch.Tensor:
        for i in (0, 1, 3):
            x = torch.relu(getattr(self, f"conv{b}_{i}")(x))
        return depth_to_space(getattr(self, f"conv{b}_2")(x), self.scale)  # no activation

    def forward(self, frames_lr: torch.Tensor, plain: bool = False, rows=None) -> dict:
        """rows=(full_h, row0): frames_lr is rows row0.. of an image of full_h
        rows (a band of parallel/spmd.sharded_forward): the flow net takes
        its rows of the whole image's resize, and the warps round their
        coordinates as the whole image's (`ops.warp.band_flow`)."""
        n, t, h, w, _ = frames_lr.shape
        out_h, out_w = h * self.scale, w * self.scale
        idx0 = t // 2
        frames_y, ref_y, flat, ref_rep = y_and_pairs(frames_lr, self.dtype)
        uv = self.flow(flat, ref_rep, rows)
        warped = splat(flat, uv, 1, plain, 0 if rows is None else rows[1]).reshape(n, t, h, w, 1)

        def frames(k):  # the k warped frames around the centre, as channels
            lo = idx0 - k // 2
            return warped[:, lo:lo + k].permute(0, 2, 3, 1, 4).reshape(n, h, w, k)

        est = [self._branch(b, frames(k)) for b, k in enumerate(BRANCH_FRAMES)]
        bil = resize_bilinear(frames_y, (out_h, out_w))  # [N,T,H,W,1]
        tem = bil.permute(0, 2, 3, 1, 4).reshape(n, out_h, out_w, t)
        tem = torch.relu(self.tem0(tem))
        tem = torch.relu(self.tem1(tem))
        weights = torch.softmax(self.tem2(tem), dim=-1)  # [N,H,W,3]
        sr = (est[0] * weights[..., 0:1] + est[1] * weights[..., 1:2]
              + est[2] * weights[..., 2:3]).float()
        return {"sr": sr[:, None], "uv": uv.reshape(n, t, h, w, 2), "frames_y": frames_y,
                "ref_y": ref_y}
