"""FRVSR: Frame-Recurrent Video Super-Resolution — counterpart of
pfnl_tpu/models/frvsr.py (reference model/frvsr.py:21-148).

  step(x, xp, est), one recurrent step on LR frames [N,h,w,3]:
    first frame (no xp, est): conv0_0 on x
    later frames: FRVSRFlow(x, xp) -> flow [N,h,w,2], |flow| < 1
      -> bilinear resize to the HR grid, values NOT rescaled (a quirk of
         the reference, model/frvsr.py:100, kept on purpose)
      -> bounded forward splat of the previous SR est [N,H,W,3], R=1
         (kernel 7 on the GPU, at the HR grid)
      -> space_to_depth(4) [N,h,w,48], concat with x -> conv0_1
    -> relu, 10 residual blocks @128 (conv1_j, relu, conv2_j, add)
    -> large1 (3x3 transposed conv, stride 2) -> relu
    -> large2 (3x3 transposed conv, stride 2) -> relu -> out (3x3 conv)
    -> SR [N,H,W,3] in the compute dtype

`forward(frames_lr)` unrolls the steps over [N,T,h,w,3] as training does
and returns {"sr": [N,T,H,W,3], "warps": [N,T-1,h,w,3]} in float32, the
LR-grid splats of the previous frame the flow loss reads.  Serving runs
`step` frame by frame with O(1) state (infer/predictor.py
`_run_recurrent`).  The JAX package's `tail_impl="packed"` is a TPU lane
rewrite of large2 and out; here they run as the plain transposed conv and
conv.  Parameter names are flax's, so `utils.weights.from_flax` carries
JAX parameters across; the trunk's kernels start from flax's lecun_normal,
the flow net's from glorot_uniform, as in the JAX package.
"""

import torch
from torch import nn

from pfnl_tpu_torch.models.blocks import Conv, ConvParams, conv_lecun
from pfnl_tpu_torch.models.flows import FRVSRFlow, splat
from pfnl_tpu_torch.ops.conv import conv2d_same, conv_transpose_same2
from pfnl_tpu_torch.ops.resize import resize_bilinear
from pfnl_tpu_torch.ops.shuffle import space_to_depth


class FRVSR(nn.Module):
    # read by the Predictor: RGB out, no LR padding, testvideos reads
    # blur{scale}/ by default, and the frames run through `step` one by one
    y_channel = False
    lr_multiple = 1
    reads_truth = False
    recurrent = True

    def __init__(self, num_frames: int = 10, scale: int = 4, mf: int = 128, num_blocks: int = 10,
                 dtype: torch.dtype = torch.float32, generator: torch.Generator = None):
        """dtype: compute dtype of the activations (float32 or bfloat16);
        parameters stay float32.  num_frames is the training unroll; serving
        takes any number of frames."""
        super().__init__()
        if scale != 4:
            raise ValueError("FRVSR's two stride-2 transposed convs are fixed at x4")
        self.num_frames, self.scale, self.mf, self.num_blocks = num_frames, scale, mf, num_blocks
        self.dtype = dtype
        self.flow = FRVSRFlow(3, dtype, generator)

        def conv(name, cin, cout):
            setattr(self, name, Conv((3, 3, cin, cout), generator, init=conv_lecun))

        conv("conv0_0", 3, mf)
        conv("conv0_1", 3 + 3 * scale * scale, mf)
        for j in range(num_blocks):
            conv(f"conv1_{j}", mf, mf)
            conv(f"conv2_{j}", mf, mf)
        self.large1 = ConvParams((3, 3, mf, mf), generator, init=conv_lecun)
        self.large2 = ConvParams((3, 3, mf, mf), generator, init=conv_lecun)
        self.out = ConvParams((3, 3, mf, 3), generator, init=conv_lecun)

    def _trunk(self, inp, first: bool):
        x = torch.relu((self.conv0_0 if first else self.conv0_1)(inp))
        for j in range(self.num_blocks):
            c1 = torch.relu(getattr(self, f"conv1_{j}")(x))
            x = x + getattr(self, f"conv2_{j}")(c1)
        for up in (self.large1, self.large2):
            x = torch.relu(conv_transpose_same2(x, up.kernel) + up.bias.to(x.dtype))
        return conv2d_same(x, self.out.kernel) + self.out.bias.to(x.dtype)

    def _upscale_warp(self, uv, est, plain: bool = False, row0: int = 0):
        """Splat the previous SR est [N,H,W,3] by the flow resized to the HR
        grid, its values unscaled (so |flow| < 1 and R=1 holds), and fold it
        back onto the LR grid [N,h,w,48].  row0: the HR row of the whole
        image that is est's first (a band)."""
        upuv = resize_bilinear(uv, (est.shape[1], est.shape[2]))
        return space_to_depth(splat(est, upuv, 1, plain, row0), self.scale)

    def step(self, x, xp=None, est=None, plain: bool = False, rows=None):
        """One recurrent step.  x: current LR [N,h,w,3]; xp: previous LR;
        est: previous SR [N,H,W,3], as the previous step returned it.
        Returns SR [N,H,W,3] in the compute dtype.  plain: the splat's plain
        version on a CUDA tensor (the reference the kernel path is held to).
        rows=(full_h, row0): x is rows row0.. of an image of full_h rows (a
        band of parallel/spmd.sharded_forward): the flow net takes its rows
        of the whole image's resize, and the splat rounds its coordinates as
        the whole image's (`ops.warp.band_flow`)."""
        x = x.to(self.dtype)
        if xp is None:
            return self._trunk(x, first=True)
        uv = self.flow(x, xp.to(self.dtype), rows)
        row0 = 0 if rows is None else self.scale * rows[1]
        est_lr = self._upscale_warp(uv, est.to(self.dtype), plain, row0)
        return self._trunk(torch.cat([x, est_lr], -1), first=False)

    def forward(self, frames_lr: torch.Tensor, plain: bool = False) -> dict:
        frames_lr = frames_lr.to(self.dtype)
        srs, warps = [], []
        sr = None
        for i in range(frames_lr.shape[1]):
            x = frames_lr[:, i]
            if i == 0:
                sr = self.step(x)
            else:
                xp = frames_lr[:, i - 1]
                uv = self.flow(x, xp)
                warps.append(splat(xp, uv, 1, plain))
                sr = self._trunk(torch.cat([x, self._upscale_warp(uv, sr, plain)], -1),
                                 first=False)
            srs.append(sr)
        return {"sr": torch.stack(srs, 1).float(), "warps": torch.stack(warps, 1).float()}
