"""DUF's forward pass, plain PyTorch, float32, BatchNorm in inference mode
(Jo et al., CVPR 2018; reference repository `model/dufvsr.py`,
`model/nets.py` FR_52L, the hand-rolled BatchNorm of `utils.py:251-278`).

    x [N,T,h,w,3]
    conv1 1x3x3 3 -> 64 (H and W padded by 1);
    dense blocks, the first n_same temporally SAME, the last n_valid
    temporally VALID:  t = conv3x3x3(relu(BN(conv1x1x1(relu(BN(x))))))
    with `growth` new channels; x = concat(x, t) (a VALID block drops x's
    first and last planes);
    relu(BN(x)), conv2 1x3x3 -> 256, relu;
    residual head: rconv2(relu(rconv1(.)))       -> [N,1,h,w,3 r r]
    filter head:   fconv2(relu(fconv1(.))), softmax over the 25 taps
                                                 -> [N,1,h,w,25,r r]
    each colour of the centre frame filtered by its pixel's 5x5 dynamic
    filters (taps row-major, zeros outside the image), depth_to_space(r),
    plus depth_to_space(r) of the residual -> [N,4h,4w,3].

BatchNorm: gamma (x - moving_mean) / sqrt(moving_variance + 1e-3) + beta.
Weights are a dict keyed by the program's parameter and buffer names.
The benchmark's serving entries (benchmark/core.py `reference`):
`LR_MULTIPLE` and `serve`.
"""

import torch
import torch.nn.functional as F

from benchmark.reference.ops import FLOAT32, conv3d, depth_to_space

EPS = 1e-3
LR_MULTIPLE = 2  # the Predictor pads every window family's LR frames, DUF's to even sizes


def _bn(p, name, x, prec):
    inv = torch.rsqrt(p[f"{name}.moving_variance"] + EPS)
    return prec(p[f"{name}.gamma"] * (x - p[f"{name}.moving_mean"]) * inv + p[f"{name}.beta"])


def _conv(p, name, x, pad, prec):
    return prec(conv3d(x, p[f"{name}.W"], pad, prec) + prec(p[f"{name}.b"]))


def forward(p, x, n_same: int, n_valid: int, scale: int = 4, prec=FLOAT32):
    """x [N,T,h,w,3] float32 -> SR [N,4h,4w,3] float32."""
    n, t, h, w, _ = x.shape
    x = prec(x)
    y = _conv(p, "G.conv1", x, (0, 1, 1), prec)
    for r in range(1, n_same + n_valid + 1):
        same = r <= n_same
        a = torch.relu(_bn(p, f"G.Rbn{r}a", y, prec))
        a = torch.relu(_bn(p, f"G.Rbn{r}b", _conv(p, f"G.Rconv{r}a", a, 0, prec), prec))
        new = _conv(p, f"G.Rconv{r}b", a, (1, 1, 1) if same else (0, 1, 1), prec)
        y = torch.cat([y if same else y[:, 1:-1], new], -1)
    y = torch.relu(_bn(p, "G.fbn1", y, prec))
    y = torch.relu(_conv(p, "G.conv2", y, (0, 1, 1), prec))
    res = _conv(p, "G.rconv2", torch.relu(_conv(p, "G.rconv1", y, 0, prec)), 0, prec)
    filt = _conv(p, "G.fconv2", torch.relu(_conv(p, "G.fconv1", y, 0, prec)), 0, prec)
    rr = scale * scale
    filt = prec(torch.softmax(filt[:, 0].reshape(n, h, w, 25, rr), dim=3))

    centre = x[:, t // 2]                                       # [N,h,w,3]
    chans = []
    for c in range(3):
        taps = F.unfold(centre[..., c][:, None], (5, 5), padding=2)   # [N,25,h w], row-major
        taps = taps.reshape(n, 25, h, w).permute(0, 2, 3, 1)
        chans.append(depth_to_space(torch.einsum("nhwp,nhwpr->nhwr", taps, filt), scale))
    sr = torch.cat(chans, -1)
    return prec(sr + depth_to_space(res[:, 0], scale))


def serve(p, x, cfg, prec=FLOAT32):
    """A window batch x [N,T,h,w,3] of LR RGB -> HR RGB [N,S h,S w,3]."""
    return forward(p, x, cfg["same_blocks"], cfg["valid_blocks"], cfg["scale"], prec)
