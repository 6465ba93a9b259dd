"""Sharded forwards over several devices from one process — counterpart of
`sharded_apply_dp` / `sharded_forward_dp` and `sharded_forward` in
pfnl_tpu/parallel/spmd.py.

Serving needs no collective: each device runs the whole single-device
program, kernels included, on its rows of the batch.  So where the JAX
package `shard_map`s the per-chip program over a mesh, one process here
holds a replica of the model on each device, splits the batch evenly by
rows, issues each shard's work on its own device (the launches are
asynchronous, so the devices run together) and gathers the results in
order onto the first device.

The JAX package's other path, `sharded_forward`, shards the batch over
`data` and the image rows over `space`, and GSPMD inserts the convs' halo
exchanges and the attention's collectives.  PyTorch has no GSPMD, so
`sharded_forward` here splits the rows into bands by hand, one program a
band, each launching its family's kernels on its rows.  It is the path for
an image too large for one device.  Three designs:

  PFNL      its stages band by band, HALO ghost rows a side refreshed from
            the neighbours after every layer (plain tensor copies between
            devices); each band's attention against every band's keys
  VESPCN, MCResNet, LTDVSR, DRVSR, DUF
            overlapped bands: a band runs the family's own forward on its
            rows and `halo` input rows a side, sliced from the caller's
            input, and keeps its own output rows; `row_geometry` gives the
            halo (the forward's receptive reach) and the alignment that
            keeps strided convs, pools and sub-pixel shuffles in phase
  FRVSR     each step of the recurrence on overlapped bands of one step's
            reach, the previous estimate's rows gathered from the bands
            that own them (`gather_rows`) before each step

JAX's GSPMD `sharded_forward` does not compute the unsharded forward of
the families that splat (its Pallas splat is a per-chip program that
GSPMD cannot partition), so these are held to the unsharded forward.
"""

import copy
from typing import NamedTuple

import torch

from pfnl_tpu_torch.models import DRVSR, DUF, FRVSR, LTDVSR, PFNL, MCResNet, VESPCN
from pfnl_tpu_torch.ops.cuda.pfnl_tail import merge_tail
from pfnl_tpu_torch.ops.cuda.pfrb import pfrb_block
from pfnl_tpu_torch.ops.pfrb_ref import compose_d2s4
from pfnl_tpu_torch.ops.resize import resize_rows
from pfnl_tpu_torch.ops.shuffle import depth_to_space, space_to_depth
from pfnl_tpu_torch.parallel.nonlocal_sp import attend, gather_blocks


def device_list(devices):
    """torch.devices, a CUDA device with its index ("cuda" is cuda:0)."""
    out = []
    for d in devices:
        d = torch.device(d)
        out.append(torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d)
    return out


def replicate(model, devices):
    """{device: a replica of model on it}; the model itself serves its own
    device, the others get copies of it (in the model's mode)."""
    own = device_list([next(model.parameters()).device])[0]
    return {d: model if d == own else copy.deepcopy(model).to(d) for d in device_list(devices)}


def sharded_apply_dp(per_device, devices):
    """call(x) running per_device(device, x_shard) -> y_shard on each of
    `devices` (torch.device) with x's rows split evenly over them, the
    results concatenated in order on devices[0].  x and y are batch-major;
    raises when the devices do not divide x's rows."""
    devices = device_list(devices)

    def call(x):
        n = len(devices)
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} does not split over {n} devices")
        shards = x.split(x.shape[0] // n)
        outs = [per_device(d, s.to(d, non_blocking=True)) for d, s in zip(devices, shards)]
        return torch.cat([o.to(devices[0]) for o in outs])

    return call


def sharded_forward_dp(model, devices):
    """fn(x) -> model(x) with x's rows split over `devices`, a replica of
    the model on each (the raw "sr" for a model returning a dict)."""
    replicas = replicate(model, devices)

    def per_device(device, x):
        out = replicas[device](x)
        return out["sr"] if isinstance(out, dict) else out

    return sharded_apply_dp(per_device, devices)


# Rows a layer reads across a band's edge, on the LR grid: the 5x5 conv0;
# a PFRB's two 3x3 convs (kernels 2 then 3, so its first rows wrong at a
# band's edge are 2 in); the tail's 3x3 merge conv and its 3x3 conv on the
# 2x grid, folded onto the LR grid (kernel 4); the bicubic's taps (rows
# floor(o/4) - 1 .. floor(o/4) + 2 for HR row o).  One halo width serves
# every layer, so each band keeps HALO ghost rows a side from conv0's input
# to the tail's output.
HALO = 2


def row_bands(h: int, space: int, align: int = 2, ragged: bool = False):
    """[(r0, r1)] of `space` bands in order covering h rows, each a multiple
    of `align` rows, differing by at most `align` rows (PFNL's
    space_to_depth(2) needs even bands); raises where h is not a multiple
    of align or h // align < space.  ragged=True takes any h: the bottom
    band takes the h % align rows past the last multiple."""
    units, rest = divmod(h, align)
    if rest and not ragged:
        raise ValueError(f"{h} rows do not split evenly into bands of multiples of {align} rows")
    if units < space:
        raise ValueError(f"{h} rows make {units} row groups of {align}, fewer than {space} bands")
    q, extra = divmod(units, space)
    bands, r0 = [], 0
    for i in range(space):
        r1 = r0 + align * (q + (i < extra))
        bands.append((r0, r1))
        r0 = r1
    bands[-1] = (bands[-1][0], h)
    return bands


def with_halo(bands, k: int, dim: int):
    """Each band (a tensor on its device, rows along `dim`) with k rows of
    each neighbour copied onto its device -> [(extended, top, bottom)], top
    and bottom the rows added (0 at the image's own edges, where the
    layer's own padding applies).  Every band holds at least k rows."""
    out = []
    for i, b in enumerate(bands):
        parts = [b]
        top = bot = 0
        if i > 0:
            prev = bands[i - 1]
            parts.insert(0, prev.narrow(dim, prev.shape[dim] - k, k).to(b.device))
            top = k
        if i + 1 < len(bands):
            parts.append(bands[i + 1].narrow(dim, 0, k).to(b.device))
            bot = k
        out.append((torch.cat(parts, dim) if len(parts) > 1 else b, top, bot))
    return out


def exchange_halos(exts, k: int, dim: int):
    """In place: the k ghost rows a side of each extended band (along `dim`,
    where it has a neighbour) overwritten by the neighbour's own rows next
    to them, as a layer left them.  A band's own rows are never written."""
    for i, e in enumerate(exts):
        if i > 0:  # the previous band's last own rows, before its k ghost rows
            prev = exts[i - 1]
            e.narrow(dim, 0, k).copy_(prev.narrow(dim, prev.shape[dim] - 2 * k, k))
        if i + 1 < len(exts):  # the next band's first own rows, after its k ghost rows
            e.narrow(dim, e.shape[dim] - k, k).copy_(exts[i + 1].narrow(dim, k, k))


def _pfnl_bands(models, xs, rows, h, impl):
    """PFNL.forward on one sample group split into row bands: xs[i] [n,T,
    r1-r0,W,3] the rows rows[i] = (r0, r1) of an image of h rows, models[i]
    the replica on band i's device -> the bands of SR [n,4(r1-r0),4W,3].
    impl: the attention on the CPU (`nonlocal_sp.attend`)."""
    m0 = models[0]
    t, scale = m0.num_frames, m0.scale
    w = xs[0].shape[3]

    # non-local block: each band's queries against every band's keys and values
    inp = [m.frame_concat(x) for m, x in zip(models, xs)]
    s2d = [space_to_depth(a, 2) for a in inp]
    nb, c = s2d[0].shape[0], s2d[0].shape[-1]
    xf = [a.reshape(nb, -1, c).contiguous() for a in s2d]
    gf = [m.nlblock_0.g(a).reshape(nb, -1, c).contiguous() for m, a in zip(models, s2d)]
    for i, (m, a) in enumerate(zip(models, s2d)):
        y = attend(xf[i], gather_blocks(xf, a.device), gather_blocks(gf, a.device), impl)
        inp[i] = inp[i] + depth_to_space(m.nlblock_0.w(y.reshape(a.shape)), 2)

    # conv0, the PFRBs and the tail on each band and its ghost rows, refreshed
    # from the neighbours after each layer
    ext = with_halo(inp, HALO, 1)
    pads = [(top, bot) for _, top, bot in ext]
    feat = [m.embed(e) for m, (e, _, _) in zip(models, ext)]
    exchange_halos(feat, HALO, 2)
    for k in range(m0.num_blocks):
        feat = [pfrb_block(f, *m.block_params(k)) for m, f in zip(models, feat)]
        exchange_halos(feat, HALO, 2)
    folded = [merge_tail(f, *m.tail_params()) for m, f in zip(models, feat)]

    centre = [x[:, t // 2].to(m.dtype) for m, x in zip(models, xs)]
    out = []
    for (cext, top, _), f, (pt, pb), (r0, r1) in zip(with_halo(centre, HALO, 1), folded, pads,
                                                   rows):
        bic = resize_rows(cext, h, r0 - top, (h * scale, w * scale), (r0 * scale, r1 * scale))
        f = f.narrow(1, pt, f.shape[1] - pt - pb)
        out.append((compose_d2s4(f) + bic).float())
    return out


# The overlapped bands' geometry.  A reach is the most LR rows an output row
# reads past its own on either side, composed layer by layer (each conv's
# window, stride and TF-SAME pad, each pool, resize and sub-pixel shuffle) as
# intervals of rows; the flow nets':
EASYFLOW_REACH = 30    # the coarse x4 branch (two stride-2 convs) 19, the x2 refinement 11 more
LTDFLOW_REACH = 20     # a 9x9 conv before each of two pools, the x4 bilinear back, a 3x3 conv
FRVSRFLOW_REACH = 65   # three levels of two 3x3 convs and a pool, three of two 3x3 convs and a
                       # x2 bilinear, two 3x3 convs (58 rows up, with the 7 rows that the
                       # resize back from where the pools floored can move a tap)


class RowGeometry(NamedTuple):
    """align: band offsets, and a band's rows and halo away from the image's
    bottom, are multiples of align (the strided convs' and pools' phase);
    halo: the input rows a band reads past each edge, its forward's reach
    rounded up to align (FRVSR: one step's); ragged: the image's height
    need not be a multiple of align (the bottom band takes the rest)."""
    align: int
    halo: int
    ragged: bool = False


def _round_up(n: int, a: int) -> int:
    return -(-n // a) * a


def row_geometry(model) -> RowGeometry:
    """The bands' RowGeometry of a family, from its configuration (DRVSR's
    frames, DUF's blocks, FRVSR's blocks)."""
    if isinstance(model, PFNL):
        # even bands (space_to_depth(2)); HALO ghost rows refreshed after every
        # layer, not an overlap
        return RowGeometry(2, HALO)
    if isinstance(model, (VESPCN, MCResNet)):
        # EasyFlow; the R=2 splat (a target row reads sources up to 2 rows
        # below); 11 trunk convs (5x5, 9 of 3x3, conv6) and rnn_out on the x2
        # grid (1 LR row): 45 -> 48 (the bicubic of the centre frame reads 2)
        return RowGeometry(4, _round_up(EASYFLOW_REACH + 2 + 13, 4))
    if isinstance(model, LTDVSR):
        # LTDFlow; the R=1 splat; a branch's 5x5 and three 3x3 convs (the
        # temporal weights' 5x5 convs on the HR grid read 3 LR rows): 26 -> 28.
        # Any height: a band takes its rows of the whole image's resize back
        # from the pools (`LTDFlow.forward(rows=)`), whose taps sit less than one
        # pooled row above a multiple of 4's, so the zero padding at a band's top
        # can reach 22 of its rows (19 at a multiple of 4); at its bottom, 23 at
        # any height
        return RowGeometry(4, _round_up(LTDFLOW_REACH + 1 + 5, 4), ragged=True)
    if isinstance(model, DRVSR):
        # EasyFlow; SPMC's x4 splat (2 rows) and SRStep on the HR grid up to
        # the last frame's decode: the encoder to the LR grid, one ConvLSTM conv
        # a frame, the decoder (T + 5 rows): 3 frames, 40
        return RowGeometry(4, _round_up(EASYFLOW_REACH + 2 + model.num_frames + 5, 4))
    if isinstance(model, DUF):
        # conv1 1x3x3, one 3x3x3 a dense block, conv2 1x3x3 (the 1x5x5 dynamic
        # filter reads the centre frame within 2 rows beside them): 52L, 26
        return RowGeometry(1, len(model.G.modes) + 2)
    if isinstance(model, FRVSR):
        # one step: FRVSRFlow; its x4 bilinear to the HR grid, the R=1 splat
        # and space_to_depth(4) (2 rows); conv0_1 with the two transposed convs
        # and `out` (2 rows), two 3x3 convs a block: 10 blocks, 89 -> 96
        return RowGeometry(8, _round_up(FRVSRFLOW_REACH + 2 + 2 + 2 * model.num_blocks, 8),
                           ragged=True)
    raise NotImplementedError(
        f"sharded_forward row-shards the seven families (PFNL, VESPCN, MCResNet, LTDVSR, "
        f"DRVSR, DUF, FRVSR), not {type(model).__name__}")


def extents(rows, h: int, halo: int):
    """[(e0, e1)]: each band's rows and `halo` rows a side, clipped to the
    image's h rows."""
    return [(max(0, r0 - halo), min(h, r1 + halo)) for r0, r1 in rows]


def gather_rows(bands, lo: int, hi: int, device):
    """Rows lo..hi (along dim 1) of an image held in pieces, bands [(r0, t)]
    with t holding rows r0..r0 + t.shape[1], in order -> one tensor on
    `device`, each row from whichever band holds it (a halo wider than a
    band spans several); raises where the bands do not cover lo..hi."""
    parts = []
    for r0, t in bands:
        a, b = max(lo, r0), min(hi, r0 + t.shape[1])
        if a < b:
            parts.append(t.narrow(1, a - r0, b - a).to(device, non_blocking=True))
    if sum(p.shape[1] for p in parts) != hi - lo:
        raise ValueError(f"rows {lo}..{hi} are not all held by the bands")
    return torch.cat(parts, 1) if len(parts) > 1 else parts[0].contiguous()


def _window_sr(model, x, h: int, row0: int = 0):
    """A window family's SR of x [N,T,h',w,3] float32, [N,T',4h',4w,C] (the
    dict's "sr" but for DUF, which returns it; DRVSR's full form without
    its `warped_lr`, which nothing here reads).  x is rows row0.. of an
    image of h rows, so that the warps round their coordinates as the
    whole image's (`ops.warp.band_flow`; DUF has no warp) and LTDVSR's flow
    net takes its rows of the whole image's resize."""
    if isinstance(model, DUF):
        return model(x)
    if isinstance(model, LTDVSR):
        return model(x, rows=(h, row0))["sr"]
    if isinstance(model, DRVSR):
        return model(x, warped_lr=False, row0=row0)["sr"]
    return model(x, row0=row0)["sr"]


def _window_bands(models, xd, devs, rows, h, halo):
    """The window family's forward on each band's rows and `halo` rows a side
    of xd [n,T,h,W,3] -> the bands of SR [n,T',4(r1-r0),4W,C] float32."""
    out = []
    for m, dev, (r0, r1), (e0, e1) in zip(models, devs, rows, extents(rows, h, halo)):
        sr = _window_sr(m, xd[:, :, e0:e1].to(dev, non_blocking=True).contiguous(), h, e0)
        s = m.scale
        out.append(sr[:, :, s * (r0 - e0):s * (r1 - e0)])
    return out


def _frvsr_bands(models, xd, devs, rows, h, halo):
    """FRVSR.forward's SR of xd [n,T,h,W,3] in bands: each step on each
    band's rows and `halo` rows a side, the previous estimate's rows there
    gathered from the bands that own them -> the bands of SR
    [n,T,4(r1-r0),4W,3] float32."""
    ext = extents(rows, h, halo)
    s = models[0].scale
    frames = [xd[:, :, e0:e1].to(dev, non_blocking=True).contiguous()
              for dev, (e0, e1) in zip(devs, ext)]
    own, srs = None, [[] for _ in rows]
    for t in range(xd.shape[1]):
        new = []
        for m, dev, x, (r0, r1), (e0, e1) in zip(models, devs, frames, rows, ext):
            if t == 0:
                sr = m.step(x[:, 0])
            else:
                est = gather_rows(own, s * e0, s * e1, dev)
                sr = m.step(x[:, t], x[:, t - 1], est, rows=(h, e0))
            new.append((s * r0, sr[:, s * (r0 - e0):s * (r1 - e0)]))
        own = new
        for band, (_, sr) in zip(srs, own):
            band.append(sr.float())
    return [torch.stack(band, 1) for band in srs]


def sharded_forward(model, devices, space: int = 1, impl: str = "auto"):
    """fn(x) -> the model's SR float32 with x [N,T,h,w,3] sharded over
    `devices` (len data x space, data-major: devices[d * space + s] holds
    band s of batch shard d): the batch split evenly over `data`, the rows
    over `space` bands (`row_bands`).  A device may appear more than once
    ([cuda:0] * 4 is four bands on one GPU).  The result is gathered in
    order on devices[0].  Forward only, under no_grad.  It is what JAX's
    `sharded_forward` is meant to compute, `model.apply(...)["sr"]`: PFNL,
    VESPCN, MCResNet, LTDVSR [N,1,4h,4w,1] (PFNL 3 channels), DRVSR's full
    form [N,T,4h,4w,1], DUF [N,1,4h,4w,3], FRVSR's unrolled recurrence
    [N,T,4h,4w,3].

    PFNL: bands of even rows (`row_bands(h, space)`).  Each band runs the
    model's stages (`PFNL.frame_concat`, `embed`, `block_params`,
    `tail_params`) on its rows: its attention queries against the keys and
    values of every band, gathered in band order (kernel 1 on the card),
    then conv0, each PFRB (kernels 2 and 3) and the tail (kernel 4) on its
    rows and HALO ghost rows a side, refreshed from its neighbours after
    each layer, and the bicubic of the centre frame on its rows.  The
    result is the unsharded forward's: bitwise on the CPU, and on the card
    where conv0 runs PyTorch's own convolution (cuDNN may pick another conv0
    algorithm for a band than for the whole image, a bf16 rounding here and
    there that the blocks spread).  impl (the CPU only): the attention,
    "auto" (the JAX package's rule: chunked above 4096 keys), "dense" or
    "chunked".

    The window families (VESPCN, MCResNet, LTDVSR, DRVSR, DUF): bands of
    multiples of `row_geometry(model).align` rows (LTDVSR's bottom band
    takes the rest of any height, its flow net its rows of the whole
    image's resize, as FRVSR's); each band runs the
    family's own forward (`_window_sr`: kernel 7, 8 or 9, and 10 under
    conv3d_impl="pallas", once a band) on its rows and row_geometry's halo
    rows a side, clipped to the image, and keeps its own output rows.  FRVSR: each step
    of the recurrence so on every band (kernel 7 once a band a step after
    the first), with the previous estimate's rows gathered from the bands
    that own them before each step; its flow net takes its rows of the
    whole image's resize.  A band's warps round their coordinates as the
    whole image's (`ops.warp.band_flow`).  The halo covers the forward's
    reach, so the result is the unsharded forward's: bitwise on the CPU,
    but where `data` splits the batch and a conv sums a smaller batch in
    another order, and on the card where cuDNN keeps the whole image's
    algorithm for a band."""
    devices = device_list(devices)
    if space < 1 or len(devices) % space:
        raise ValueError(f"{len(devices)} devices do not split into bands of space={space}")
    geo = row_geometry(model)
    if isinstance(model, DUF) and model.training:
        raise ValueError("sharded_forward runs DUF in eval mode: a training-mode BatchNorm "
                         "would normalise each band by its own statistics")
    data = len(devices) // space
    replicas = replicate(model, devices)

    @torch.no_grad()
    def fn(x):
        n, _, h, _, _ = x.shape
        if n % data:
            raise ValueError(f"a batch of {n} does not split over data={data}")
        rows = row_bands(h, space, geo.align, geo.ragged)
        out = []
        for d, xd in enumerate(x.split(n // data)):
            devs = devices[d * space:(d + 1) * space]
            models = [replicas[dev] for dev in devs]
            if isinstance(model, PFNL):
                xs = [xd[:, :, r0:r1].to(dev, non_blocking=True)
                      for dev, (r0, r1) in zip(devs, rows)]
                bands = [b[:, None] for b in _pfnl_bands(models, xs, rows, h, impl)]
            elif isinstance(model, FRVSR):
                bands = _frvsr_bands(models, xd, devs, rows, h, geo.halo)
            else:
                bands = _window_bands(models, xd, devs, rows, h, geo.halo)
            out.append(torch.cat([b.to(devices[0]) for b in bands], 2))
        return torch.cat(out)

    return fn
