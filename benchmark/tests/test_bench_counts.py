"""The frozen counts against a brute-force count at tiny shapes: torch's
FlopCounterMode over the program's plain versions of each kernel and over
the benchmark's references; bytes against the tensors each call reads and
writes."""

import math

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark.counts import duf_model, ops, peaks, pfnl_model
from benchmark.reference import duf, pfnl

GEN = torch.Generator().manual_seed(3)


def _r(*shape):
    return torch.rand(shape, generator=GEN) - 0.5


def _flops(fn, *args):
    with FlopCounterMode(display=False) as fc:
        out = fn(*args)
    return fc.get_total_flops(), out


def _bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _shapes(*tensors):
    return [list(t.shape) for t in tensors]


N, T, H, W, C = 2, 3, 5, 6, 8


def test_pfrb_a_and_b():
    from pfnl_tpu_torch.ops.pfrb_ref import pfrb_a_ref, pfrb_b_ref

    feat, w1, b1, wf, bf = _r(N, T, H, W, C), _r(3, 3, C, C), _r(C), _r(T, C, C), _r(C)
    f, (i1, base) = _flops(pfrb_a_ref, feat, w1, b1, wf, bf)
    flops, nbytes = ops.pfrb_a(_shapes(feat, w1, b1, wf, bf), None, 4)
    assert flops == f
    assert nbytes == _bytes(feat, w1, b1, wf, bf, i1, base)
    w2f, w2b, b2 = _r(3, 3, C, C), _r(3, 3, C, C), _r(C)
    f, out = _flops(pfrb_b_ref, feat, i1, base, w2f, w2b, b2)
    flops, nbytes = ops.pfrb_b(_shapes(feat, i1, base, w2f, w2b, b2), None, 4)
    assert flops == f
    assert nbytes == _bytes(feat, i1, base, w2f, w2b, b2, out)


def test_pfrb_backward_halves():
    from pfnl_tpu_torch.ops.pfrb_ref import pfrb_bwd_a_ref, pfrb_bwd_b_ref

    dz2, i1, base, w2f, w2b = _r(N, T, H, W, C), _r(N, T, H, W, C), _r(N, H, W, C), \
        _r(3, 3, C, C), _r(3, 3, C, C)
    f, outs = _flops(pfrb_bwd_b_ref, dz2, i1, base, w2f, w2b)
    flops, nbytes = ops.pfrb_bwd_b(_shapes(dz2, i1, base, w2f, w2b), None, 4)
    assert flops == f
    d_i1, d_base, dw2f, dw2b, db2 = outs
    assert nbytes == _bytes(dz2, i1, base, w2f, w2b, d_i1, d_base, dw2f, dw2b) + 2 * 4 * C
    dz1, feat, g, w1 = _r(N, T, H, W, C), _r(N, T, H, W, C), _r(N, T, H, W, C), _r(3, 3, C, C)
    f, (d_feat, dw1, db1) = _flops(pfrb_bwd_a_ref, dz1, feat, g, w1)
    flops, nbytes = ops.pfrb_bwd_a(_shapes(dz1, feat, g, w1), None, 4)
    assert flops == f
    assert nbytes == _bytes(dz1, feat, g, w1, d_feat, dw1, db1)


def test_nonlocal_attention():
    from pfnl_tpu_torch.ops.nonlocal_attn import nonlocal_attention

    theta, g = _r(2, 30, 12), _r(2, 30, 12)
    f, out = _flops(nonlocal_attention, theta, theta, g)
    flops, nbytes = ops.nonlocal_flash(_shapes(theta, theta, g), None, 2)
    assert flops == f
    assert nbytes == 2 * (theta.numel() * 2 + g.numel() + out.numel())


@pytest.mark.parametrize("mode,lo,hi", [("thw", 0, 7), ("hw", 0, 7), ("hw", 1, 6), ("hw", 2, 5)])
def test_duf_block(mode, lo, hi):
    from pfnl_tpu_torch.ops.duf_ref import BlockParams, block_out_planes, dense_block_ref

    f, g, nb, h, w = 24, 4, 2, 5, 6
    p = BlockParams(sa=_r(f), oa=_r(f), wa=_r(f, f), sb=_r(f), ob=_r(f), wb=_r(3, 3, 3, f, g),
                    bb=_r(g), mode=mode)
    buf = _r(nb, 7, h, w, f + g)
    flops, _ = _flops(dense_block_ref, buf, p, lo, hi)
    shapes = _shapes(buf, buf, p.sa, p.oa, p.wa, p.sb, p.ob, p.wb, p.bb)
    got, nbytes = ops.duf_block(shapes, [lo, hi, mode == "thw"], 4)
    assert got == flops
    olo, ohi = block_out_planes(mode, lo, hi)
    assert nbytes == 4 * (nb * h * w * ((hi - lo) * f + (ohi - olo) * g) + f * f + 27 * f * g
                          + 4 * f + g)
    # without the scalars, the planes follow from F in DUF's order (here 4 SAME-T blocks)
    if (mode, lo) == ("hw", 0):
        f2 = 64 + g * 4
        p2 = p._replace(wa=_r(f2, f2), wb=_r(3, 3, 3, f2, g))
        shapes = _shapes(buf, buf, p.sa, p.oa, p2.wa, p.sb, p.ob, p2.wb, p.bb)
        assert ops.duf_block(shapes, None, 4, n_same=4)[0] == \
            ops.duf_block(shapes, [0, 7, False], 4)[0]


def _no_resize(monkeypatch):
    monkeypatch.setattr(pfnl, "resize_bicubic",
                        lambda x, size: x.new_zeros(x.shape[0], size[0], size[1], x.shape[-1]))


def _pfnl_params(cfg):
    from benchmark import weights
    from pfnl_tpu_torch.models import PFNL

    model = PFNL(**cfg["port_kwargs"])
    return weights.draw({k: tuple(v.shape) for k, v in model.state_dict().items()}, cfg["init"],
                        5, "cpu")


CFG = {"num_frames": 3, "mf": 8, "num_blocks": 2, "scale": 4,
       "port_kwargs": {"num_frames": 3, "mf": 8, "num_blocks": 2},
       "init": [["kernel$", "glorot"], ["bias$", "range:-0.1:0.1"]]}


def test_pfnl_forward_ops(monkeypatch):
    _no_resize(monkeypatch)
    p = _pfnl_params(CFG)
    x = torch.rand(2, 3, 8, 12, 3, generator=GEN)
    f, _ = _flops(pfnl.forward, p, x, 2)
    assert pfnl_model.forward_ops(CFG, 2, 8, 12) == f


def test_pfnl_training_step_ops(monkeypatch):
    _no_resize(monkeypatch)
    p = {k: v.requires_grad_(True) for k, v in _pfnl_params(CFG).items()}
    x = torch.rand(2, 3, 8, 8, 3, generator=GEN)
    with FlopCounterMode(display=False) as fc:
        pfnl.forward(p, x, 2).square().mean().backward()
    assert pfnl_model.train_step_ops(CFG, 2, 8, 8) == fc.get_total_flops()


def test_duf_forward_ops():
    from benchmark import weights
    from pfnl_tpu_torch.models import DUF

    cfg = {"num_frames": 7, "scale": 4, "same_blocks": 3, "valid_blocks": 3, "growth": 32,
           "layers": 16}
    model = DUF(layers=16)
    w = weights.draw({k: tuple(v.shape) for k, v in model.state_dict().items()},
                     [["\\.W$", "he"], ["moving_variance$", "range:0.5:1.5"], ["", "range:0:0.1"]],
                     5, "cpu")
    x = torch.rand(1, 7, 6, 8, 3, generator=GEN)
    f, _ = _flops(duf.forward, w, x, 3, 3)
    assert duf_model.forward_ops(cfg, 1, 6, 8) == f


def test_bound_is_the_larger_of_the_two_times():
    assert peaks.bound_s(989e12, 0, "bfloat16") == pytest.approx(1.0)
    assert peaks.bound_s(0, 3.35e12, "float32") == pytest.approx(1.0)
    assert peaks.bound_s(165e12, 1.0, "float32") == pytest.approx(1.0)
    assert math.isclose(peaks.PEAK_FLOPS["float32"] * 3, 495e12)
