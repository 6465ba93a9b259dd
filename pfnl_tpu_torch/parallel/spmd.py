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
`sharded_forward` here runs PFNL's stages band by band and exchanges the
halos by hand (plain tensor copies between devices): each band of rows
runs the model's own kernels, K1-K4 on the card, on its rows and the halo
rows its layer reads across the band's edges.  It is the path for an image
too large for one device.  PFNL only: the other families' row-sharded
forwards are still to port (ROADMAP.md, Queue 1).
"""

import copy

import torch

from pfnl_tpu_torch.models.pfnl import PFNL
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


def row_bands(h: int, space: int):
    """[(r0, r1)] of `space` bands of even row counts, in order, covering h
    rows and differing by at most one row pair (space_to_depth(2) needs
    even bands); raises where h is odd or h/2 < space."""
    if h % 2:
        raise ValueError(f"sharded_forward needs an even row count, got {h}")
    pairs = h // 2
    if pairs < space:
        raise ValueError(f"{h} rows make {pairs} row pairs, fewer than {space} bands")
    q, extra = divmod(pairs, space)
    bands, r0 = [], 0
    for i in range(space):
        r1 = r0 + 2 * (q + (i < extra))
        bands.append((r0, r1))
        r0 = r1
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


def sharded_forward(model, devices, space: int = 1, impl: str = "auto"):
    """fn(x) -> PFNL's SR [N,1,4h,4w,3] float32 with x [N,T,h,w,3] sharded
    over `devices` (len data x space, data-major: devices[d * space + s]
    holds band s of batch shard d): the batch split evenly over `data`,
    the rows over `space` bands of even rows that differ by at most one
    row pair (`row_bands`).  A device may appear more than once ([cuda:0]
    * 4 is four bands on one GPU).  The result is gathered in order on
    devices[0].  Forward only, under no_grad.

    Each band runs the model's stages (`PFNL.frame_concat`, `embed`,
    `block_params`, `tail_params`) on its rows: its attention queries
    against the keys and values of every band, gathered in band order
    (kernel 1 on the card), then conv0, each PFRB (kernels 2 and 3) and the
    tail (kernel 4) on its rows and HALO ghost rows a side, refreshed from
    its neighbours after each layer, and the bicubic of the centre frame on
    its rows.  The result is the unsharded forward's: bitwise on the CPU,
    and on the card where conv0 runs PyTorch's own convolution (cuDNN may
    pick another conv0 algorithm for a band than for the whole image, a
    bf16 rounding here and there that the blocks spread).  impl
    (the CPU only): the attention, "auto" (the JAX package's rule: chunked
    above 4096 keys), "dense" or "chunked"."""
    if not isinstance(model, PFNL):
        raise NotImplementedError(
            f"sharded_forward row-shards PFNL only, not {type(model).__name__}")
    devices = device_list(devices)
    if space < 1 or len(devices) % space:
        raise ValueError(f"{len(devices)} devices do not split into bands of space={space}")
    data = len(devices) // space
    replicas = replicate(model, devices)

    @torch.no_grad()
    def fn(x):
        n, _, h, _, _ = x.shape
        if n % data:
            raise ValueError(f"a batch of {n} does not split over data={data}")
        rows = row_bands(h, space)
        out = []
        for d, xd in enumerate(x.split(n // data)):
            devs = devices[d * space:(d + 1) * space]
            xs = [xd[:, :, r0:r1].to(dev, non_blocking=True) for dev, (r0, r1) in zip(devs, rows)]
            bands = _pfnl_bands([replicas[dev] for dev in devs], xs, rows, h, impl)
            out.append(torch.cat([b.to(devices[0]) for b in bands], 1))
        return torch.cat(out)[:, None]

    return fn
