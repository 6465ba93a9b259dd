"""PFNL: Progressive Fusion Video SR via Non-Local Spatio-Temporal
Correlations (ICCV 2019) — counterpart of pfnl_tpu/models/pfnl.py.

  x [N,T,h,w,3]
    -> frames concat [N,h,w,3T] -> space_to_depth(2) -> NonLocalBlock
       -> depth_to_space(2) -> residual add
    -> shared 5x5 conv0 per frame (+lrelu)                [N,T,h,w,64]
    -> num_blocks x PFRB      (kernels 2 and 3 on the GPU; 5 and 6 backward)
    -> merge tail on the LR grid -> [N,h,w,48]       (kernel 4 on the GPU)
    -> compose_d2s4 -> [N,4h,4w,3] -> + bicubic(centre frame)
    -> [N,1,4h,4w,3] float32

The PFRB is the JAX package's refactor of the reference block: the
1x1 fusion over the frame concat is a sum of per-frame [C,C] products
(`conv10_{i}_kernel` [T,C,C]) and conv2 over concat(base, i1_t) splits into
`conv2b_{i}` (base, computed once) + `conv2f_{i}` (frame).  Parameter
names and layouts are flax's, so `utils.weights.from_flax` bridges them.
"""

import torch
from torch import nn

from pfnl_tpu_torch.models.blocks import ConvParams, NonLocalBlock, conv_glorot, glorot_uniform
from pfnl_tpu_torch.ops.conv import conv2d_same
from pfnl_tpu_torch.ops.cuda.pfnl_tail import merge_tail
from pfnl_tpu_torch.ops.pfrb_chain import pfrb_chain
from pfnl_tpu_torch.ops.pfrb_ref import (compose_d2s4, leaky_relu, pfnl_tail_ref,
                                         pfrb_chain_ref)
from pfnl_tpu_torch.ops.resize import resize_bicubic
from pfnl_tpu_torch.ops.shuffle import depth_to_space, space_to_depth


class PFNL(nn.Module):
    # read by the Predictor: RGB out, LR padded to an even size for
    # space_to_depth(2), testvideos degrades truth/ by default
    y_channel = False
    lr_multiple = 2
    reads_truth = True
    recurrent = False

    def __init__(self, num_frames: int = 7, scale: int = 4, mf: int = 64, num_blocks: int = 20,
                 dtype: torch.dtype = torch.float32, generator: torch.Generator = None):
        """dtype: compute dtype of the activations (float32 or bfloat16);
        parameters stay float32.  generator: the source of the
        variance-matched random init (pfnl_tpu `_xavier_with_fans`)."""
        super().__init__()
        if scale != 4:
            raise ValueError("PFNL's merge tail is fixed at x4")
        t, c = num_frames, 3
        self.num_frames, self.scale, self.mf, self.num_blocks = t, scale, mf, num_blocks
        self.dtype = dtype
        self.nlblock_0 = NonLocalBlock(c * t * 4, generator)
        self.conv0 = ConvParams((5, 5, c, mf), generator)

        # fans of the reference's concatenated kernels
        conv1_fans = (9 * mf, 9 * mf)     # 3x3 over [.., mf]
        fuse_fans = (t * mf, mf)          # 1x1 over [.., t*mf]
        conv2_fans = (9 * 2 * mf, 9 * mf)  # 3x3 over [.., 2*mf]

        def param(name, value):
            self.register_parameter(name, nn.Parameter(value))

        for i in range(num_blocks):
            param(f"conv1_{i}_kernel", glorot_uniform((3, 3, mf, mf), *conv1_fans, generator))
            param(f"conv1_{i}_bias", torch.zeros(mf))
            param(f"conv10_{i}_kernel", glorot_uniform((t, mf, mf), *fuse_fans, generator))
            param(f"conv10_{i}_bias", torch.zeros(mf))
            param(f"conv2f_{i}_kernel", glorot_uniform((3, 3, mf, mf), *conv2_fans, generator))
            param(f"conv2b_{i}_kernel", glorot_uniform((3, 3, mf, mf), *conv2_fans, generator))
            param(f"conv2f_{i}_bias", torch.zeros(mf))
        param("convmerge1_kernel", conv_glorot((3, 3, t * mf, 48), generator))
        param("convmerge1_bias", torch.zeros(48))
        param("convmerge2_kernel", conv_glorot((3, 3, 12, 12), generator))
        param("convmerge2_bias", torch.zeros(12))

    def block_params(self, i: int):
        """(W1, b1, Wfuse, bfuse, W2f, W2b, b2) of PFRB i."""
        return (getattr(self, f"conv1_{i}_kernel"), getattr(self, f"conv1_{i}_bias"),
                getattr(self, f"conv10_{i}_kernel"), getattr(self, f"conv10_{i}_bias"),
                getattr(self, f"conv2f_{i}_kernel"), getattr(self, f"conv2b_{i}_kernel"),
                getattr(self, f"conv2f_{i}_bias"))

    def forward(self, x: torch.Tensor, plain: bool = False) -> torch.Tensor:
        """x [N,T,h,w,3] -> SR [N,1,4h,4w,3] float32.  On a CUDA tensor the
        attention (above the dense limit), the PFRBs and the tail run the
        port's kernels, and a backward runs kernels 5 and 6, unless
        plain=True asks for their plain PyTorch versions under plain
        autograd (the reference the kernels are checked against on the
        card)."""
        n, t, h, w, c = x.shape
        if t != self.num_frames:
            raise ValueError(f"expected {self.num_frames} frames, got {t}")
        dt, mf = self.dtype, self.mf
        run_chain, run_tail = (pfrb_chain_ref, pfnl_tail_ref) if plain else (pfrb_chain, merge_tail)
        xc = x.to(dt)

        # non-local residual over the frame-concat image
        inp0 = xc.permute(0, 2, 3, 1, 4).reshape(n, h, w, t * c)
        nl = self.nlblock_0(space_to_depth(inp0, 2), plain=plain)
        inp0 = inp0 + depth_to_space(nl, 2)

        # shared 5x5 conv0, frames folded into the batch
        frames = inp0.reshape(n, h, w, t, c).permute(0, 3, 1, 2, 4).reshape(n * t, h, w, c)
        feat = leaky_relu(conv2d_same(frames, self.conv0.kernel) + self.conv0.bias.to(dt))
        feat = feat.reshape(n, t, h, w, mf).contiguous()

        feat = run_chain(feat, [self.block_params(i) for i in range(self.num_blocks)])

        folded = run_tail(feat, self.convmerge1_kernel, self.convmerge1_bias,
                          self.convmerge2_kernel, self.convmerge2_bias)
        bic = resize_bicubic(xc[:, t // 2], (h * self.scale, w * self.scale))
        sr = (compose_d2s4(folded) + bic).float()
        return sr[:, None]
