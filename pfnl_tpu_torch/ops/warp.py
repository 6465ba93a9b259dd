"""Optical-flow warps, bilinear, NHWC (counterpart: pfnl_tpu/ops/warp.py).

Flow channel 0 is x (column displacement), channel 1 is y (row).  Images
are [B,H,W,C] or [B,T,H,W,C] (T folded into the batch), flows [B,H,W,2]
or [B,T,H,W,2].  Coordinates are computed in float32 whatever the input
dtype; outputs keep the image's dtype.

  backward_warp_local      bilinear gather for |uv| <= R, edge-replicated
                           (EasyFlow's coarse stage), output clipped to
                           [0,1]; XLA in the JAX package, plain here too
  forward_warp             the reference's scatter splat (index_add_),
                           indices clipped: the independent oracle
  forward_warp_local_ref   bounded same-size splat as (2R+2)^2 masked
                           shift-adds on a padded canvas, then the border
                           fold: kernel 7's plain version
  forward_warp_local_spmc  SPMC upscale-while-warp splat as s^2 phase
                           canvases of (2R+1)^2 shift-adds each, then the
                           interleave and the fold: kernel 8's plain version
  forward_warp_local,      the public splats: kernel 7 / kernel 8 on a CUDA
  forward_warp_spmc        tensor (under autograd through their Functions),
                           the plain versions above on a CPU tensor
  bounded_splat_adjoint,   the splats' gradients: gathers of the cotangent
  spmc_splat_adjoint       at the clipped tap positions (XLA in the JAX
                           package, plain here too)

The bounded splats keep the TPU kernels' acceptance windows: a tap lands
only when its offset from the source lies in the window (|offset| <= R+1
for kernel 7, [-sR, sR+s-1] on the HR grid for kernel 8).  A flow beyond
the bound loses the taps outside the window; the scatter `forward_warp`
keeps them.  Taps that land outside the image are folded onto the border
row or column, which is the reference's index clipping
(modules/videosr_ops.py:455-466).
"""

import torch

from pfnl_tpu_torch.ops.cuda import bounded_splat as _k7
from pfnl_tpu_torch.ops.cuda import spmc_splat as _k8


def _fold5d(x):
    if x.dim() == 5:
        n, t = x.shape[:2]
        return x.reshape((n * t,) + x.shape[2:]), (n, t)
    return x, None


def _unfold5d(x, fold):
    return x if fold is None else x.reshape(fold + x.shape[1:])


def _taps(uv: torch.Tensor, scale: int = 1):
    """Float32 bilinear taps of sources moved by uv, on a grid `scale`
    times finer: (wa, wb, wc, wd) paired a=(y0,x0) b=(y1,x0) c=(y0,x1)
    d=(y1,x1), and the integer offsets dx0 = x0 - scale*gx, dy0 = y0 -
    scale*gy of the (y0, x0) tap from the source's own cell."""
    b, h, w, _ = uv.shape
    uvf = uv.float()
    gx = torch.arange(w, dtype=torch.float32, device=uv.device)[None, None, :]
    gy = torch.arange(h, dtype=torch.float32, device=uv.device)[None, :, None]
    x = gx + uvf[..., 0]
    y = gy + uvf[..., 1]
    if scale != 1:  # the reference's coordinate scaling (videosr_ops.py:407-408)
        x, y = x * scale, y * scale
    x0f, y0f = torch.floor(x), torch.floor(y)
    wa = (x0f + 1.0 - x) * (y0f + 1.0 - y)
    wb = (x0f + 1.0 - x) * (y - y0f)
    wc = (x - x0f) * (y0f + 1.0 - y)
    wd = (x - x0f) * (y - y0f)
    dx0 = (x0f - scale * gx).to(torch.int32)
    dy0 = (y0f - scale * gy).to(torch.int32)
    return (wa, wb, wc, wd), dx0, dy0


def fold_border(canvas: torch.Tensor, m: int) -> torch.Tensor:
    """[B,H+2m,W+2m,C] padded canvas -> [B,H,W,C]: the m margin rows and
    columns are summed onto the border (rows first, then columns)."""
    h, w = canvas.shape[1] - 2 * m, canvas.shape[2] - 2 * m
    mid = canvas[:, m:m + h].clone()
    mid[:, 0] += canvas[:, :m].sum(1)
    mid[:, h - 1] += canvas[:, m + h:].sum(1)
    out = mid[:, :, m:m + w].clone()
    out[:, :, 0] += mid[:, :, :m].sum(2)
    out[:, :, w - 1] += mid[:, :, m + w:].sum(2)
    return out


def backward_warp_local(im: torch.Tensor, uv: torch.Tensor, max_disp: int = 1) -> torch.Tensor:
    """Bilinear gather warp for |uv| <= max_disp: each output pixel reads
    its (2R+2)^2 statically shifted neighbours of the edge-replicated
    image, masked by its taps (= the reference's clipped-index gather,
    videosr_ops.py:355-366, for bounded flows).  Output clipped to [0,1]."""
    im, fold = _fold5d(im)
    uv, _ = _fold5d(uv)
    b, h, w, c = im.shape
    r = int(max_disp)
    p = r + 1
    (wa, wb, wc, wd), dx0, dy0 = _taps(uv)
    imf = torch.nn.functional.pad(im.float().permute(0, 3, 1, 2), (p, p, p, p),
                                  mode="replicate")
    out = torch.zeros((b, c, h, w), dtype=torch.float32, device=im.device)
    for dy in range(-r, r + 2):
        iy0, iy1 = (dy0 == dy).float(), (dy0 == dy - 1).float()
        qa, qc = wa * iy0 + wb * iy1, wc * iy0 + wd * iy1
        for dx in range(-r, r + 2):
            m = qa * (dx0 == dx).float() + qc * (dx0 == dx - 1).float()
            out = out + m[:, None] * imf[:, :, p + dy:p + dy + h, p + dx:p + dx + w]
    out = out.clamp(0.0, 1.0).to(im.dtype).permute(0, 2, 3, 1)
    return _unfold5d(out, fold)


def forward_warp(im: torch.Tensor, uv: torch.Tensor, out_size=None) -> torch.Tensor:
    """The reference's bilinear splat (imwarp_forward,
    videosr_ops.py:399-503): every tap of every source accumulates at its
    index clipped into the output, by index_add_.  out_size (H',W') may
    exceed the input (SPMC).  Float32 output."""
    im, fold = _fold5d(im)
    uv, _ = _fold5d(uv)
    b, h, w, c = im.shape
    oh, ow = (h, w) if out_size is None else (int(out_size[0]), int(out_size[1]))
    uvf = uv.float()
    gx = torch.arange(w, dtype=torch.float32, device=im.device)[None, None, :]
    gy = torch.arange(h, dtype=torch.float32, device=im.device)[None, :, None]
    x = (gx + uvf[..., 0]) * (oh / h)  # quirk kept: x scaled by the height ratio
    y = (gy + uvf[..., 1]) * (ow / w)  # and y by the width ratio
    x0f, y0f = torch.floor(x), torch.floor(y)
    x1f, y1f = x0f + 1.0, y0f + 1.0
    weights = ((x1f - x) * (y1f - y), (x1f - x) * (y - y0f),
               (x - x0f) * (y1f - y), (x - x0f) * (y - y0f))
    x0 = x0f.long().clamp(0, ow - 1)
    x1 = x1f.long().clamp(0, ow - 1)
    y0 = y0f.long().clamp(0, oh - 1)
    y1 = y1f.long().clamp(0, oh - 1)
    base = torch.arange(b, device=im.device)[:, None, None] * (oh * ow)
    ids = torch.cat([(base + yy * ow + xx).reshape(-1)
                     for yy, xx in ((y0, x0), (y1, x0), (y0, x1), (y1, x1))])
    flat = im.reshape(-1, c).float()
    data = torch.cat([wgt.reshape(-1, 1) * flat for wgt in weights])
    out = torch.zeros((b * oh * ow, c), dtype=torch.float32, device=im.device)
    out.index_add_(0, ids, data)
    return _unfold5d(out.reshape(b, oh, ow, c), fold)


def forward_warp_local_ref(im: torch.Tensor, uv: torch.Tensor, max_disp: int = 1) -> torch.Tensor:
    """Kernel 7's plain version: im [B,H,W,C], uv [B,H,W,2] -> [B,H,W,C]
    in im's dtype.  (2R+2)^2 masked shift-adds of the source into a
    float32 canvas padded by p = R+1, then the border fold
    (pfnl_tpu/ops/warp.py:176-220)."""
    b, h, w, c = im.shape
    r = int(max_disp)
    p = r + 1
    (wa, wb, wc, wd), dx0, dy0 = _taps(uv)
    imf = im.float()
    canvas = torch.zeros((b, h + 2 * p, w + 2 * p, c), dtype=torch.float32, device=im.device)
    for dy in range(-r, r + 2):
        iy0, iy1 = (dy0 == dy).float(), (dy0 == dy - 1).float()
        for dx in range(-r, r + 2):
            ix0, ix1 = (dx0 == dx).float(), (dx0 == dx - 1).float()
            m = wa * iy0 * ix0 + wb * iy1 * ix0 + wc * iy0 * ix1 + wd * iy1 * ix1
            canvas[:, p + dy:p + dy + h, p + dx:p + dx + w] += imf * m[..., None]
    return fold_border(canvas, p).to(im.dtype)


def forward_warp_local_spmc(im: torch.Tensor, uv: torch.Tensor, scale: int,
                            max_disp: int = 2) -> torch.Tensor:
    """Kernel 8's plain version: im [B,H,W,C], uv [B,H,W,2] ->
    [B,sH,sW,C] in im's dtype.  Each source reaches HR offsets dy in
    [-sR, sR+s-1] from s*(its cell); grouped by HR phase (py, px) the
    splat is (2R+1)^2 LR shift-adds per phase canvas (padded by p = R+1
    LR cells), then the phase interleave and the border fold
    (pfnl_tpu/ops/warp.py:293-365).  The term masks are factored by row
    and column as the TPU kernel factors them (spmc_splat.py:52-63):
    every term is still im * w of the one tap that matches."""
    b, h, w, c = im.shape
    s, r = int(scale), int(max_disp)
    p = r + 1
    (wa, wb, wc, wd), dx0, dy0 = _taps(uv, s)
    imf = im.float()
    # per distinct row offset dy: the image times the weights of the taps in that row
    pa, pc = {}, {}
    for dy in range(-s * r, s * r + s):
        iy0, iy1 = (dy0 == dy).float()[..., None], (dy0 == dy - 1).float()[..., None]
        pa[dy] = imf * (wa[..., None] * iy0 + wb[..., None] * iy1)
        pc[dy] = imf * (wc[..., None] * iy0 + wd[..., None] * iy1)
    ix = {dx: (dx0 == dx).float()[..., None] for dx in range(-s * r - 1, s * r + s)}
    h2, w2 = h + 2 * p, w + 2 * p
    phases = torch.zeros((s, s, b, h2, w2, c), dtype=torch.float32, device=im.device)
    for py in range(s):
        for px in range(s):
            canvas = phases[py, px]
            for ey in range(-r, r + 1):
                dy = s * ey + py
                for ex in range(-r, r + 1):
                    dx = s * ex + px
                    canvas[:, p + ey:p + ey + h, p + ex:p + ex + w] += (
                        pa[dy] * ix[dx] + pc[dy] * ix[dx - 1])
    hr = phases.permute(2, 3, 0, 4, 1, 5).reshape(b, h2 * s, w2 * s, c)
    return fold_border(hr, p * s).to(im.dtype)


def _splat_adjoint(im, uv, g, scale: int):
    """The bilinear splat's adjoint: the four taps of each source gather the
    float32 cotangent at their positions clipped into g's grid, weighted by
    the taps of the unclipped floors (pfnl_tpu/ops/warp.py `_bsplat_bwd`,
    `_spmc_bwd`).  Returns (d_im, d_uv) in the inputs' dtypes; d_uv sums
    over the channels, times `scale` (the coordinates' own scaling)."""
    b, h, w, _ = im.shape
    oh, ow = g.shape[1], g.shape[2]
    gf, imf, uvf = g.float(), im.float(), uv.float()
    gx = torch.arange(w, dtype=torch.float32, device=im.device)[None, None, :]
    gy = torch.arange(h, dtype=torch.float32, device=im.device)[None, :, None]
    x = gx + uvf[..., 0]
    y = gy + uvf[..., 1]
    if scale != 1:
        x, y = x * scale, y * scale
    x0f, y0f = torch.floor(x), torch.floor(y)
    x1f, y1f = x0f + 1.0, y0f + 1.0
    x0, x1 = x0f.long().clamp(0, ow - 1), x1f.long().clamp(0, ow - 1)
    y0, y1 = y0f.long().clamp(0, oh - 1), y1f.long().clamp(0, oh - 1)
    bidx = torch.arange(b, device=im.device)[:, None, None]
    ga, gb, gc, gd = gf[bidx, y0, x0], gf[bidx, y1, x0], gf[bidx, y0, x1], gf[bidx, y1, x1]
    ax, bx = (x1f - x)[..., None], (x - x0f)[..., None]
    ay, by = (y1f - y)[..., None], (y - y0f)[..., None]
    d_im = ax * ay * ga + ax * by * gb + bx * ay * gc + bx * by * gd
    d_x = -ay * ga - by * gb + ay * gc + by * gd
    d_y = -ax * ga + ax * gb - bx * gc + bx * gd
    d_uv = torch.stack([(imf * d_x).sum(-1), (imf * d_y).sum(-1)], -1)
    if scale != 1:
        d_uv = d_uv * scale
    return d_im.to(im.dtype), d_uv.to(uv.dtype)


def bounded_splat_adjoint(im: torch.Tensor, uv: torch.Tensor, g: torch.Tensor,
                          max_disp: int) -> tuple:
    """Gradients (d_im, d_uv) of kernel 7's splat `forward_warp_local(im, uv,
    max_disp)` for the cotangent g [B,H,W,C]; the bound needs no window
    here (|uv| <= max_disp keeps every tap inside it)."""
    return _splat_adjoint(im, uv, g, 1)


def spmc_splat_adjoint(im: torch.Tensor, uv: torch.Tensor, g: torch.Tensor, scale: int,
                       max_disp: int) -> tuple:
    """Gradients (d_im, d_uv) of kernel 8's splat `forward_warp_spmc(im, uv,
    scale, max_disp)` for the cotangent g [B,sH,sW,C]."""
    return _splat_adjoint(im, uv, g, int(scale))


def _needs_graph(*tensors) -> bool:
    """A CUDA call whose result autograd must differentiate: it goes through
    the kernel's Function (kernel forward, plain adjoint backward)."""
    return (tensors[0].device.type != "cpu" and torch.is_grad_enabled()
            and any(t.requires_grad for t in tensors))


def forward_warp_local(im: torch.Tensor, uv: torch.Tensor, max_disp: int = 1) -> torch.Tensor:
    """Bounded same-size bilinear splat (|uv| <= max_disp): kernel 7 on a
    CUDA tensor (through `BoundedSplat` when autograd records), the plain
    `forward_warp_local_ref` on a CPU tensor."""
    im, fold = _fold5d(im)
    uv, _ = _fold5d(uv)
    if _needs_graph(im, uv):
        return _unfold5d(_k7.BoundedSplat.apply(im, uv, int(max_disp)), fold)
    return _unfold5d(_k7.bounded_splat(im, uv, int(max_disp)), fold)


def forward_warp_spmc(im: torch.Tensor, uv: torch.Tensor, scale: int,
                      max_disp: int = 2) -> torch.Tensor:
    """SPMC upscale-while-warp splat of a single-channel image
    ([B,H,W,1] or [N,T,H,W,1]) for |uv| <= max_disp: kernel 8 on a CUDA
    tensor (through `SpmcSplat` when autograd records), the plain
    `forward_warp_local_spmc` on a CPU tensor."""
    im, fold = _fold5d(im)
    uv, _ = _fold5d(uv)
    if im.shape[-1] != 1:
        raise ValueError(f"forward_warp_spmc is single-channel (Y) only, got C={im.shape[-1]}")
    if _needs_graph(im, uv):
        return _unfold5d(_k8.SpmcSplat.apply(im, uv, int(scale), int(max_disp)), fold)
    return _unfold5d(_k8.spmc_splat(im, uv, int(scale), int(max_disp)), fold)
