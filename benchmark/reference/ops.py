"""Plain PyTorch operations of the benchmark's references, in float32.

The references compute what the configurations state, written from the
published equations: PFNL (reference repository `model/pfnl.py`, its
non-local block `utils.py:18-71`) and DUF-52L (`model/dufvsr.py`,
`model/nets.py`).  They import nothing of the program under test, nor of
the JAX package: every operation here is written out again.

Layouts are channels-last, [N,H,W,C] and [N,T,H,W,C]; conv kernels are
HWIO / DHWIO, as the weights are named and laid out by the benchmark.

`Precision` rounds the operands and outputs of every layer: float32 leaves
them as they are (the reference); "bfloat16" and "fp8" round them to
those types, products still summed in float32, which is how the control
puts the reference in the program's place at the precision below the one
a configuration states.
"""

import functools

import numpy as np
import torch
import torch.nn.functional as F

FP8_MAX = 448.0  # largest finite float8_e4m3fn


class Precision:
    """Rounding of activations and weights: "float32" (none), "bfloat16", or
    "fp8" (float8 e4m3 with one scale a tensor, amax to 448, as an fp8
    serving path scales its tensors)."""

    def __init__(self, name: str = "float32"):
        if name not in ("float32", "bfloat16", "fp8"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "float32":
            return x
        if self.name == "bfloat16":
            return x.to(torch.bfloat16).float()
        amax = x.detach().abs().amax().clamp_min(1e-30)
        scale = amax / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).float() * scale


FLOAT32 = Precision("float32")


def lrelu(x, alpha: float = 0.2):
    return torch.where(x > 0, x, alpha * x)


def conv2d_same(x, k, prec=FLOAT32):
    """Stride-1 TF-SAME conv: x [N,H,W,Ci], k [kh,kw,Ci,Co] -> [N,H,W,Co];
    TF pads k-1 in all, the smaller half before."""
    kh, kw = k.shape[0], k.shape[1]
    pads = ((kw - 1) // 2, kw - 1 - (kw - 1) // 2, (kh - 1) // 2, kh - 1 - (kh - 1) // 2)
    y = F.conv2d(F.pad(prec(x).permute(0, 3, 1, 2), pads), prec(k).permute(3, 2, 0, 1))
    return y.permute(0, 2, 3, 1)


def conv3d(x, k, pad, prec=FLOAT32):
    """x [N,T,H,W,Ci], k [kt,kh,kw,Ci,Co]; pad (t, h, w) zeros a side, then VALID."""
    y = F.conv3d(prec(x).permute(0, 4, 1, 2, 3), prec(k).permute(4, 3, 0, 1, 2), padding=pad)
    return y.permute(0, 2, 3, 4, 1)


def depth_to_space(x, r: int):
    """[N,H,W,C r r] -> [N,H r,W r,C], TF's channel order (dy r + dx) C + c."""
    n, h, w, crr = x.shape
    c = crr // (r * r)
    return x.reshape(n, h, w, r, r, c).permute(0, 1, 3, 2, 4, 5).reshape(n, h * r, w * r, c)


def space_to_depth(x, r: int):
    """The inverse of depth_to_space."""
    n, hr, wr, c = x.shape
    h, w = hr // r, wr // r
    return x.reshape(n, h, r, w, r, c).permute(0, 1, 3, 2, 4, 5).reshape(n, h, w, r * r * c)


def attention(theta, phi, g, block: int = 4096):
    """softmax(theta phi^T) g over the last two axes, no 1/sqrt(d), float32:
    theta [B,N,D], phi [B,M,D], g [B,M,Dv].  Queries in blocks, so the
    scores of one block ([B,block,M]) are what is held."""
    out = []
    for q0 in range(0, theta.shape[1], block):
        s = torch.einsum("bnd,bmd->bnm", theta[:, q0:q0 + block], phi)
        out.append(torch.einsum("bnm,bmv->bnv", torch.softmax(s, dim=-1), g))
    return torch.cat(out, 1)


@functools.lru_cache(maxsize=16)
def bicubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_out, n_in] weights of TF1's legacy bicubic resize
    (resize_images, align_corners=False): source x = dst * n_in / n_out,
    Keys' cubic with a = -0.75, taps clamped to the border."""
    a = -0.75
    src = np.arange(n_out, dtype=np.float64) * (n_in / n_out)
    base = np.floor(src).astype(np.int64)
    w = np.zeros((n_out, n_in))
    for tap in (-1, 0, 1, 2):
        idx = base + tap
        d = np.abs(src - idx)
        kern = np.where(d <= 1, (a + 2) * d ** 3 - (a + 3) * d ** 2 + 1,
                        np.where(d < 2, a * d ** 3 - 5 * a * d ** 2 + 8 * a * d - 4 * a, 0.0))
        np.add.at(w, (np.arange(n_out), np.clip(idx, 0, n_in - 1)), kern)
    return w.astype(np.float32)


def resize_bicubic(x, size):
    """x [N,H,W,C] -> [N,H',W',C] by the two separable products, in x's type."""
    wh = torch.as_tensor(bicubic_matrix(x.shape[1], size[0]), device=x.device, dtype=x.dtype)
    ww = torch.as_tensor(bicubic_matrix(x.shape[2], size[1]), device=x.device, dtype=x.dtype)
    return torch.einsum("oh,nhwc,pw->nopc", wh, x, ww)


def gaussian_kernel(size: int = 13, sigma: float = 1.6) -> np.ndarray:
    r = size // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    g = np.exp(-0.5 * x * x / (sigma * sigma))
    g /= g.sum()
    return np.outer(g, g).astype(np.float32)


def degrade(gt, scale: int = 4):
    """[N,T,H,W,C] -> [N,T,H/scale,W/scale,C]: the PFNL training degradation
    (reference utils.py DownSample): reflect-pad 6, a 13x13 Gaussian of
    sigma 1.6 on each channel, every `scale`-th pixel kept."""
    n, t, h, w, c = gt.shape
    k = torch.as_tensor(gaussian_kernel(), device=gt.device, dtype=gt.dtype)
    x = F.pad(gt.reshape(n * t, h, w, c).permute(0, 3, 1, 2), (6, 6, 6, 6), mode="reflect")
    y = F.conv2d(x, k[None, None].expand(c, 1, 13, 13).contiguous(), stride=scale, groups=c)
    return y.permute(0, 2, 3, 1).reshape(n, t, y.shape[2], y.shape[3], c)


def to_uint8(x):
    """float [0,1] -> uint8 by round(clip(255 x)), ties to even."""
    return torch.round(torch.clamp(x.float() * 255.0, 0, 255)).to(torch.uint8)


def clamped_window(num_frames: int, centre: int, t: int):
    """Frame indices of the t-frame window centred on `centre`, clamped to the clip."""
    return [min(max(centre + d - t // 2, 0), num_frames - 1) for d in range(t)]


def pad_to_multiple(x, mult: int):
    """[N,T,h,w,C] edge-padded at the bottom and right to multiples of mult."""
    ph, pw = (-x.shape[2]) % mult, (-x.shape[3]) % mult
    if not (ph or pw):
        return x
    n, t, h, w, c = x.shape
    y = F.pad(x.reshape(n * t, h, w, c).permute(0, 3, 1, 2), (0, pw, 0, ph), mode="replicate")
    return y.permute(0, 2, 3, 1).reshape(n, t, h + ph, w + pw, c)


def tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
