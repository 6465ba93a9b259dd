"""Per-call counts of the program's kernel ops, `torch.ops.pfnl.*`, by the
function each computes (the arithmetic of chip_smoke.py:606-645 for
kernels 1-4, :932-934 for kernels 5 and 6 and :1255-1257 for kernel 9,
frozen here).  Each counter takes the op's input shapes (lists, in the
op's argument order), its scalar arguments (None where the trace did not
record them) and the activations' element size, and returns (operations,
bytes).  Activations and conv or product weights are counted at the
activation type, per-channel vectors and weight gradients at float32.
"""

import math

CONV_TAPS = 9      # 3x3
WGRAD_F32 = 4      # weight gradients and bias vectors are float32


def _n(shape):
    return math.prod(shape)


def pfrb_a(shapes, scalars, elem):
    """feat [n,t,h,w,c], W1, b1, Wfuse, bfuse -> i1 [n,t,h,w,c], base [n,h,w,c]."""
    feat, w1, b1, wfuse, bfuse = shapes[:5]
    n, t, h, w, c = feat
    flops = 2.0 * n * t * h * w * c * c * CONV_TAPS + 2.0 * n * h * w * t * c * c
    nbytes = elem * (2 * _n(feat) + _n(w1) + _n(wfuse) + n * h * w * c) + WGRAD_F32 * 2 * c
    return flops, nbytes


def pfrb_b(shapes, scalars, elem):
    """feat, i1, base, W2f, W2b, b2 -> out [n,t,h,w,c]."""
    feat, i1, base, w2f, w2b, b2 = shapes[:6]
    n, t, h, w, c = feat
    flops = 2.0 * CONV_TAPS * c * c * (n * t * h * w + n * h * w)
    nbytes = elem * (3 * _n(feat) + _n(base) + _n(w2f) + _n(w2b)) + WGRAD_F32 * c
    return flops, nbytes


def nonlocal_flash(shapes, scalars, elem):
    """theta [b,n,d], phi [b,m,d], g [b,m,dv] -> softmax(theta phi^T) g [b,n,dv]."""
    theta, phi, g = shapes[:3]
    b, n, d = theta
    m, dv = g[1], g[2]
    flops = 2.0 * b * n * m * (d + dv)
    nbytes = elem * (_n(theta) + _n(phi) + _n(g) + b * n * dv)
    return flops, nbytes


def pfrb_bwd_b(shapes, scalars, elem):
    """dz2 [n,t,h,w,c], i1, base, W2f^T, W2b^T -> d_i1, d_base, dW2f|db2, dW2b."""
    dz2, i1, base, w2ft, w2bt = shapes[:5]
    n, t, h, w, c = dz2
    flops = 2.0 * CONV_TAPS * c * c * (2 * n * t * h * w + 2 * n * h * w)
    nbytes = (elem * (3 * _n(dz2) + 2 * _n(base) + _n(w2ft) + _n(w2bt))
              + WGRAD_F32 * 2 * (CONV_TAPS * c * c + c))
    return flops, nbytes


def pfrb_bwd_a(shapes, scalars, elem):
    """dz1 [n,t,h,w,c], feat, g, W1^T -> d_feat, dW1|db1."""
    dz1, feat, g, w1t = shapes[:4]
    n, t, h, w, c = dz1
    flops = 2.0 * CONV_TAPS * c * c * 2 * n * t * h * w
    nbytes = elem * (4 * _n(dz1) + _n(w1t)) + WGRAD_F32 * (CONV_TAPS * c * c + c)
    return flops, nbytes


def duf_block(shapes, scalars, elem, n_same=None):
    """buf [nb,t,h,w,C], scratch, sa, oa, Wa [F,F], sb, ob, Wb [3,3,3,F,G], bb,
    in_lo, in_hi, thw: reads planes [in_lo, in_hi) of the first F channels,
    writes G new channels on each output plane (all of them in a SAME-T
    block, all but the first and last in a VALID-T one).  Without the scalar
    arguments, the planes follow from F: the blocks with F below
    64 + 16 n_same are SAME-T over all planes, each later one VALID-T and
    two planes narrower (DUF-52L's order)."""
    buf, wa, wb = shapes[0], shapes[4], shapes[7]
    nb, t, h, w = buf[:4]
    f, g = wa[0], wb[-1]
    if scalars is not None and scalars[0] is not None:
        in_lo, in_hi, thw = scalars
        n_in = in_hi - in_lo
        n_out = n_in if thw else n_in - 2
    else:
        k = (f - 64) // g - n_same        # VALID-T blocks before this one, or < 0
        n_in = t if k < 0 else t - 2 * k
        n_out = n_in if k < 0 else n_in - 2
    flops = 2.0 * nb * h * w * (n_in * f * f + n_out * 27 * f * g)
    nbytes = (elem * (nb * h * w * (n_in * f + n_out * g) + f * f + 27 * f * g)
              + WGRAD_F32 * (4 * f + g))
    return flops, nbytes


COUNTERS = {"pfnl::pfrb_a": pfrb_a, "pfnl::pfrb_b": pfrb_b,
            "pfnl::nonlocal_flash": nonlocal_flash, "pfnl::pfrb_bwd_b": pfrb_bwd_b,
            "pfnl::pfrb_bwd_a": pfrb_bwd_a, "pfnl::duf_block": duf_block}
