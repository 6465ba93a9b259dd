"""The port's CUDA kernels as `torch.library` custom ops, namespace `pfnl`.

One op per C entry family (the `_f32` / `_bf16` entry is chosen from the
activation dtype):

  torch.ops.pfnl.nonlocal_flash  kernel 1     torch.ops.pfnl.bounded_splat  kernel 7
  torch.ops.pfnl.pfrb_a          kernel 2     torch.ops.pfnl.spmc_splat     kernel 8
  torch.ops.pfnl.pfrb_b          kernel 3     torch.ops.pfnl.duf_block      kernel 9
  torch.ops.pfnl.pfnl_tail       kernel 4     torch.ops.pfnl.duf_dense      kernel 10
  torch.ops.pfnl.pfrb_bwd_b      kernel 5
  torch.ops.pfnl.pfrb_bwd_a      kernel 6

Each op has a CUDA kernel, which allocates the outputs, launches the C
entry through `_build.call` and adds one to `_build.launches[name]`, and a
fake implementation, which gives the outputs' shapes, dtypes and devices
from the inputs alone (no pointer, no launch).  So `torch.export` traces a
launch as one graph node, the exported program holds it, and a launch from
a loaded artifact counts where tracing counts none.  The ops take their
inputs as the C entry reads them: the wrappers (ops/cuda/*.py) check them,
cast the weights, and keep the plain PyTorch version for a CPU tensor.  The
ops record no autograd graph; the wrappers refuse inputs that require grad.

Every op is pure but `duf_block`, which writes the block's new channels into
its buffer in place (and uses its scratch), as kernel 9 is designed to: it
declares both as mutated.

Importing this module registers the ops and builds nothing: the library is
compiled at the first launch.  `torch.export.load` needs the ops
registered, so a process that loads an artifact imports this module.
"""

from typing import Tuple

import torch

from pfnl_tpu_torch.ops.cuda import _build

# The ops are defined through the dispatcher's own API (torch.library.Library:
# a schema, a CUDA kernel, a fake kernel).  `torch.library.custom_op` defines the
# same ops behind Python autograd and aliasing wrappers that run at every call,
# which made the back-to-back calls of the short kernels 4, 7 and 8 measurably
# slower on the card (PERF.md, section 6, PR 13).
_LIB = torch.library.Library("pfnl", "DEF")


def pfnl_op(name: str, mutates_args=()):
    """Define torch.ops.pfnl.<name> from the function's annotations
    (torch.library.infer_schema), the function its CUDA kernel; the returned
    function gains `register_fake`."""
    def wrap(fn):
        _LIB.define(name + torch.library.infer_schema(fn, mutates_args=mutates_args))
        _LIB.impl(name, fn, "CUDA")
        fn.register_fake = lambda fake: torch.library.register_fake(f"pfnl::{name}", fake,
                                                                    lib=_LIB)
        return fn
    return wrap


CHANNELS, MERGE = 64, 48     # PFRB width; the tail's folded output (4 phases x 12)
WGRAD_ENTRIES = 9 * CHANNELS * CHANNELS + CHANNELS  # kernels 5/6: dW [3,3,64,64], then db [64]


def _launch(name: str, entry: str, *args):
    _build.call(entry, *args)
    _build.launches[name] += 1


def _entry(name: str, dtype: torch.dtype) -> str:
    return f"pfnl_{name}_{_build.suffix(dtype)}"


# --- kernel 1 ------------------------------------------------------------------------------

@pfnl_op("nonlocal_flash")
def nonlocal_flash(theta: torch.Tensor, phi: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    b, n, d = theta.shape
    m, dv = g.shape[1], g.shape[2]
    out = torch.empty(b, n, dv, dtype=g.dtype, device=g.device)
    _launch("nonlocal_flash", _entry("nonlocal_flash", g.dtype), theta, phi, g, out,
            b, n, m, d, dv)
    return out


@nonlocal_flash.register_fake
def _(theta, phi, g):
    return g.new_empty(theta.shape[0], theta.shape[1], g.shape[2])


# --- kernels 2 and 3 -----------------------------------------------------------------------

@pfnl_op("pfrb_a")
def pfrb_a(feat: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor, wfuse: torch.Tensor,
           bfuse: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    n, t, h, w, c = feat.shape
    i1 = torch.empty_like(feat)
    base = feat.new_empty(n, h, w, c)
    _launch("pfrb_a", _entry("pfrb_a", feat.dtype), feat, w1, b1, wfuse, bfuse, i1, base,
            n, t, h, w)
    return i1, base


@pfrb_a.register_fake
def _(feat, w1, b1, wfuse, bfuse):
    n, t, h, w, c = feat.shape
    return torch.empty_like(feat), feat.new_empty(n, h, w, c)


@pfnl_op("pfrb_b")
def pfrb_b(feat: torch.Tensor, i1: torch.Tensor, base: torch.Tensor, w2f: torch.Tensor,
           w2b: torch.Tensor, b2: torch.Tensor) -> torch.Tensor:
    n, t, h, w, _ = feat.shape
    out = torch.empty_like(feat)
    _launch("pfrb_b", _entry("pfrb_b", feat.dtype), feat, i1, base, w2f, w2b, b2, out,
            n, t, h, w)
    return out


@pfrb_b.register_fake
def _(feat, i1, base, w2f, w2b, b2):
    return torch.empty_like(feat)


# --- kernel 4 ------------------------------------------------------------------------------

@pfnl_op("pfnl_tail")
def pfnl_tail(feat5: torch.Tensor, wm1: torch.Tensor, bm1: torch.Tensor, wf: torch.Tensor,
              bf: torch.Tensor) -> torch.Tensor:
    n, t, h, w, _ = feat5.shape
    m = feat5.new_empty(n, h, w, MERGE)      # the merge head's output, the second conv's input
    out = feat5.new_empty(n, h, w, MERGE)
    # the C entries are pfnl_tail_f32 / pfnl_tail_bf16
    _launch("pfnl_tail", _entry("tail", feat5.dtype), feat5, wm1, bm1, wf, bf, m, out,
            n, t, h, w)
    return out


@pfnl_tail.register_fake
def _(feat5, wm1, bm1, wf, bf):
    n, _, h, w, _ = feat5.shape
    return feat5.new_empty(n, h, w, MERGE)


# --- kernels 5 and 6 -----------------------------------------------------------------------

def _wgrad_scratch(device) -> torch.Tensor:
    """The per-range partial sums of the weight gradients, as pfrb_bwd.cu sizes them."""
    entries = _build.constant("pfnl_wgrad_entries")
    if entries != WGRAD_ENTRIES:
        raise RuntimeError(f"pfrb_bwd.cu reduces {entries} entries, expected {WGRAD_ENTRIES}")
    return torch.empty(_build.constant("pfnl_wgrad_scratch_floats"), dtype=torch.float32,
                       device=device)


@pfnl_op("pfrb_bwd_b")
def pfrb_bwd_b(dz2: torch.Tensor, i1: torch.Tensor, base: torch.Tensor, w2ft: torch.Tensor,
               w2bt: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    n, t, h, w, c = dz2.shape
    part = _wgrad_scratch(dz2.device)
    d_i1 = torch.empty_like(dz2)
    dzsum = dz2.new_empty(n, h, w, c)
    d_base = torch.empty_like(dzsum)
    gw2f = torch.empty(WGRAD_ENTRIES, dtype=torch.float32, device=dz2.device)
    gw2b = torch.empty_like(gw2f)
    _launch("pfrb_bwd_b", _entry("pfrb_bwd_b", dz2.dtype), dz2, i1, base, w2ft, w2bt, d_i1,
            dzsum, d_base, part, gw2f, gw2b, n, t, h, w)
    return d_i1, d_base, gw2f, gw2b


@pfrb_bwd_b.register_fake
def _(dz2, i1, base, w2ft, w2bt):
    n, t, h, w, c = dz2.shape
    gw = dz2.new_empty(WGRAD_ENTRIES, dtype=torch.float32)
    return torch.empty_like(dz2), dz2.new_empty(n, h, w, c), gw, torch.empty_like(gw)


@pfnl_op("pfrb_bwd_a")
def pfrb_bwd_a(dz1: torch.Tensor, feat: torch.Tensor, g: torch.Tensor,
               w1t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    n, t, h, w, _ = dz1.shape
    part = _wgrad_scratch(dz1.device)
    d_feat = torch.empty_like(dz1)
    gw1 = torch.empty(WGRAD_ENTRIES, dtype=torch.float32, device=dz1.device)
    _launch("pfrb_bwd_a", _entry("pfrb_bwd_a", dz1.dtype), dz1, feat, g, w1t, d_feat, part, gw1,
            n, t, h, w)
    return d_feat, gw1


@pfrb_bwd_a.register_fake
def _(dz1, feat, g, w1t):
    return torch.empty_like(dz1), dz1.new_empty(WGRAD_ENTRIES, dtype=torch.float32)


# --- kernels 7 and 8 -----------------------------------------------------------------------

@pfnl_op("bounded_splat")
def bounded_splat(im: torch.Tensor, uv: torch.Tensor, max_disp: int) -> torch.Tensor:
    b, h, w, c = im.shape
    out = torch.empty_like(im)
    _launch("bounded_splat", _entry("bounded_splat", im.dtype), im, uv, out, b, h, w, c,
            max_disp)
    return out


@bounded_splat.register_fake
def _(im, uv, max_disp):
    return torch.empty_like(im)


@pfnl_op("spmc_splat")
def spmc_splat(im: torch.Tensor, uv: torch.Tensor, scale: int, max_disp: int) -> torch.Tensor:
    b, h, w, _ = im.shape
    out = im.new_empty(b, h * scale, w * scale, 1)
    _launch("spmc_splat", _entry("spmc_splat", im.dtype), im, uv, out, b, h, w, max_disp)
    return out


@spmc_splat.register_fake
def _(im, uv, scale, max_disp):
    b, h, w, _ = im.shape
    return im.new_empty(b, h * scale, w * scale, 1)


# --- kernel 9 ------------------------------------------------------------------------------

@pfnl_op("duf_block", mutates_args=("buf", "scratch"))
def duf_block(buf: torch.Tensor, scratch: torch.Tensor, sa: torch.Tensor, oa: torch.Tensor,
              wa: torch.Tensor, sb: torch.Tensor, ob: torch.Tensor, wb: torch.Tensor,
              bb: torch.Tensor, in_lo: int, in_hi: int, thw: bool) -> None:
    nb, t, h, w, c = buf.shape
    f, g = wa.shape[0], wb.shape[-1]
    _launch("duf_block", _entry("duf_block", buf.dtype), buf, scratch, sa, oa, wa, sb, ob, wb,
            bb, nb, t, h, w, c, f, g, in_lo, in_hi, int(thw))


@duf_block.register_fake
def _(buf, scratch, sa, oa, wa, sb, ob, wb, bb, in_lo, in_hi, thw):
    return None


# --- kernel 10 -----------------------------------------------------------------------------

@pfnl_op("duf_dense")
def duf_dense(x: torch.Tensor, wk: torch.Tensor, pad_t: bool) -> torch.Tensor:
    nb, t, h, w, f = x.shape
    g = wk.shape[-1]
    out = x.new_empty(nb, t if pad_t else t - 2, h, w, g)
    _launch("duf_dense", _entry("duf_dense", x.dtype), x, wk, out, nb, t, h, w, f, g,
            int(pad_t))
    return out


@duf_dense.register_fake
def _(x, wk, pad_t):
    nb, t, h, w, _ = x.shape
    return x.new_empty(nb, t if pad_t else t - 2, h, w, wk.shape[-1])
