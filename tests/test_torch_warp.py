"""The port's warps (ops/warp.py) against the JAX package's, on the CPU.

Kernels 7 and 8 run in the JAX package as Pallas kernels in interpret mode
here (`forward_warp_local(..., impl="pallas")`, `forward_warp_spmc`), and
the port's plain versions and public entries are held to them within
float32 atol 1e-5 (both sum the same float32 terms in other orders),
including flows at the bound, at corners, and one flow beyond it, whose
taps outside the window both drop.  A CPU tensor launches no kernel.
"""

import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from pfnl_tpu.ops import warp as jwarp

from pfnl_tpu_torch.ops import warp
from pfnl_tpu_torch.ops.cuda import launches

ATOL = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _flows(rng, shape, r):
    """Flows in [-r, r] with the bound met at two corners, and one flow
    beyond it (2.6 R right, 1.3 R up)."""
    uv = ((rng.random(shape + (2,)) * 2 - 1) * r).astype(np.float32)
    uv[0, 0, 0] = [r, -r]
    uv[-1, -1, -1] = [-r, r]
    uv[0, shape[1] // 2, shape[2] // 2] = [2.6 * r, -1.3 * r]
    return uv


@pytest.mark.parametrize("r,c", [(1, 3), (2, 1)])
def test_bounded_splat_matches_pallas_kernel(r, c):
    rng = np.random.default_rng(r)
    im = rng.random((2, 13, 17, c)).astype(np.float32)
    uv = _flows(rng, (2, 13, 17), r)
    want = np.asarray(jwarp.forward_warp_local(jnp.asarray(im), jnp.asarray(uv), r,
                                               impl="pallas"))
    before = sum(launches.values())
    got = warp.forward_warp_local(_t(im), _t(uv), r).numpy()
    ref = warp.forward_warp_local_ref(_t(im), _t(uv), r).numpy()
    assert sum(launches.values()) == before  # a CPU tensor launches no kernel
    assert got.shape == im.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(got, ref)
    # the beyond-bound flow drops taps that the scatter splat keeps
    scatter = warp.forward_warp(_t(im), _t(uv)).numpy()
    assert np.abs(scatter - got).max() > 1e-3


@pytest.mark.parametrize("r", [1, 2])
def test_bounded_splat_matches_scatter_in_bound(r):
    rng = np.random.default_rng(10 + r)
    im = rng.random((2, 11, 15, 3)).astype(np.float32)
    uv = ((rng.random((2, 11, 15, 2)) * 2 - 1) * r).astype(np.float32)
    uv[0, 0, 0], uv[1, -1, -1] = [r, -r], [-r, r]
    got = warp.forward_warp_local(_t(im), _t(uv), r).numpy()
    np.testing.assert_allclose(got, warp.forward_warp(_t(im), _t(uv)).numpy(), atol=ATOL)
    np.testing.assert_allclose(got, np.asarray(jwarp.forward_warp(jnp.asarray(im),
                                                                  jnp.asarray(uv))), atol=ATOL)


def test_bounded_splat_folds_5d_and_keeps_bf16():
    rng = np.random.default_rng(3)
    im = rng.random((1, 2, 13, 17, 3)).astype(np.float32)
    uv = _flows(rng, (2, 13, 17), 1).reshape(1, 2, 13, 17, 2)
    got = warp.forward_warp_local(_t(im), _t(uv), 1)
    flat = warp.forward_warp_local(_t(im[0]), _t(uv[0]), 1)
    assert got.shape == (1, 2, 13, 17, 3)
    np.testing.assert_array_equal(got[0].numpy(), flat.numpy())
    got16 = warp.forward_warp_local(_t(im).bfloat16(), _t(uv).bfloat16(), 1)
    assert got16.dtype == torch.bfloat16 and got16.shape == (1, 2, 13, 17, 3)
    want16 = jwarp.forward_warp_local(jnp.asarray(im, jnp.bfloat16), jnp.asarray(uv, jnp.bfloat16),
                                      1, impl="pallas")
    assert want16.dtype == jnp.bfloat16
    # both splat float32 terms of the same bf16 inputs and round once
    np.testing.assert_allclose(got16.float().numpy(), np.asarray(want16, np.float32),
                               atol=2 ** -7)


def test_spmc_splat_matches_pallas_kernel():
    rng = np.random.default_rng(4)
    im = rng.random((3, 8, 12, 1)).astype(np.float32)
    uv = _flows(rng, (3, 8, 12), 2)
    want = np.asarray(jwarp.forward_warp_spmc(jnp.asarray(im), jnp.asarray(uv), 4))
    before = sum(launches.values())
    got = warp.forward_warp_spmc(_t(im), _t(uv), 4).numpy()
    ref = warp.forward_warp_local_spmc(_t(im), _t(uv), 4, 2).numpy()
    assert sum(launches.values()) == before
    assert got.shape == (3, 32, 48, 1)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_array_equal(got, ref)
    scatter = warp.forward_warp(_t(im), _t(uv), (32, 48)).numpy()
    assert np.abs(scatter - got).max() > 1e-3  # the beyond-bound flow's taps dropped


def test_spmc_splat_matches_scatter_in_bound_and_folds_5d():
    rng = np.random.default_rng(5)
    im = rng.random((1, 2, 6, 9, 1)).astype(np.float32)
    uv = ((rng.random((1, 2, 6, 9, 2)) - 0.5) * 4).astype(np.float32)
    uv[0, 0, 0, 0], uv[0, 1, -1, -1] = [2.0, -2.0], [-2.0, 2.0]
    got = warp.forward_warp_spmc(_t(im), _t(uv), 4)
    assert got.shape == (1, 2, 24, 36, 1)
    want = np.asarray(jwarp.forward_warp(jnp.asarray(im[0]), jnp.asarray(uv[0]), (24, 36)))
    np.testing.assert_allclose(got[0].numpy(), want, atol=ATOL)
    np.testing.assert_allclose(got[0].numpy(), warp.forward_warp(_t(im[0]), _t(uv[0]),
                                                                 (24, 36)).numpy(), atol=ATOL)
    got16 = warp.forward_warp_spmc(_t(im).bfloat16(), _t(uv).bfloat16(), 4)
    assert got16.dtype == torch.bfloat16
    with pytest.raises(ValueError):
        warp.forward_warp_spmc(_t(np.zeros((1, 6, 9, 3), np.float32)), _t(uv[0, :1]), 4)


@pytest.mark.parametrize("r", [1, 2])
def test_backward_warp_local_matches_jax(r):
    rng = np.random.default_rng(20 + r)
    im = rng.random((2, 9, 14, 3)).astype(np.float32)
    uv = _flows(rng, (2, 9, 14), r)
    want = np.asarray(jwarp.backward_warp_local(jnp.asarray(im), jnp.asarray(uv), r))
    got = warp.backward_warp_local(_t(im), _t(uv), r).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
    # in bound it is the reference's clipped gather
    uv_in = np.clip(uv, -r, r)
    np.testing.assert_allclose(warp.backward_warp_local(_t(im), _t(uv_in), r).numpy(),
                               np.asarray(jwarp.backward_warp(jnp.asarray(im),
                                                              jnp.asarray(uv_in))), atol=1e-6)


@pytest.mark.parametrize("out_size", [None, (36, 56)])
def test_forward_warp_matches_jax(out_size):
    rng = np.random.default_rng(30)
    im = rng.random((2, 9, 14, 2)).astype(np.float32)
    uv = (rng.standard_normal((2, 9, 14, 2)) * 3).astype(np.float32)
    want = np.asarray(jwarp.forward_warp(jnp.asarray(im), jnp.asarray(uv), out_size))
    got = warp.forward_warp(_t(im), _t(uv), out_size).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


def _class_schedule(im, uv, r, s, tiles):
    """Kernels 7 (s = 1) and 8 (s = 4) as their tiles sum, emulated in
    float32 numpy over the whole image: each source's four taps (the
    window [-R, R+1], or [-sR, sR+s-1] on kernel 8's s-times finer grid,
    the border clamp), the sources split into colour classes (i mod P,
    j mod P), P = 2R+2 for kernel 7 and 2R+1 for kernel 8, numbered
    n = (i mod P) * P + (j mod P), class n added into float tile n % tiles
    after the classes before it, each source's taps in the plain version's
    order, then the tiles added in order.  Asserts that no two sources of
    one class reach a common clamped target."""
    b, h, w, c = im.shape
    oh, ow, p = s * h, s * w, 2 * r + 2 if s == 1 else 2 * r + 1
    f32 = np.float32
    gy, gx = np.meshgrid(np.arange(h, dtype=f32), np.arange(w, dtype=f32), indexing="ij")
    xs, ys = (gx + uv[..., 0]) * f32(s), (gy + uv[..., 1]) * f32(s)
    x0f, y0f = np.floor(xs), np.floor(ys)
    wx = (x0f + f32(1) - xs, xs - x0f)
    wy = (y0f + f32(1) - ys, ys - y0f)
    dx0 = x0f.astype(np.int64) - s * gx.astype(np.int64)
    dy0 = y0f.astype(np.int64) - s * gy.astype(np.int64)
    lo, hi = -s * r, r + 1 if s == 1 else s * r + s - 1

    def target(d, base, n):
        return np.where((d >= lo) & (d <= hi), np.clip(base + d, 0, n - 1), -1)

    rows = [target(dy0 + k, s * gy.astype(np.int64), oh) for k in range(2)]
    cols = [target(dx0 + k, s * gx.astype(np.int64), ow) for k in range(2)]
    acc = np.zeros((tiles, b, oh, ow, c), f32)
    bi = np.arange(b)[:, None, None] * np.ones((1, h, w), np.int64)
    ii, jj = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    for ci in range(p):
        for cj in range(p):
            cls = (ii % p == ci) & (jj % p == cj)
            owner = {}
            for kx in range(2):
                for ky in range(2):
                    ok = cls[None] & (rows[ky] >= 0) & (cols[kx] >= 0)
                    for src, tgt in zip(zip(*np.nonzero(ok)),
                                        zip(bi[ok], rows[ky][ok], cols[kx][ok])):
                        assert owner.setdefault(tgt, src[1:]) == src[1:], (
                            f"class ({ci},{cj}): sources {owner[tgt]} and {src[1:]} reach {tgt}")
                    term = im[ok] * (wx[kx][ok] * wy[ky][ok])[:, None]
                    np.add.at(acc[(ci * p + cj) % tiles], (bi[ok], rows[ky][ok], cols[kx][ok]),
                              term.astype(f32))
    out = acc[0]
    for t in range(1, tiles):
        out = out + acc[t]
    return out


@pytest.mark.parametrize("s", [1, 4])
@pytest.mark.parametrize("r", [0, 1, 2])
def test_splat_class_schedule_is_race_free_and_matches_plain(s, r):
    """The order kernels 7 and 8 sum in on the card (csrc/splat_tile.cuh):
    no two sources of one colour class reach one clamped target, so the
    sources of a class add without atomics, and the class-by-class sums
    (kernel 7 keeps 4 float tiles for one channel, 1 for three; kernel 8
    one) match the plain versions within 1e-6 of max|plain| in float32, on
    random flows up to 1.5x beyond the bound (their taps outside the
    window dropped) and images narrower than two classes."""
    rng = np.random.default_rng(40 + 3 * r + s)
    cases = ((1, 4), (3, 1)) if s == 1 else ((1, 1),)
    for (b, h, w), (c, tiles) in itertools.product(((2, 13, 17), (1, 3, 2)), cases):
        im = rng.random((b, h, w, c)).astype(np.float32)
        uv = ((rng.random((b, h, w, 2)) * 2 - 1) * 1.5 * max(r, 1)).astype(np.float32)
        uv[0, 0, 0], uv[-1, -1, -1] = [-max(r, 1)] * 2, [max(r, 1)] * 2  # folds at two corners
        got = _class_schedule(im, uv, r, s, tiles)
        if s == 1:
            ref = warp.forward_warp_local_ref(_t(im), _t(uv), r).numpy()
        else:
            ref = warp.forward_warp_local_spmc(_t(im), _t(uv), s, r).numpy()
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-6 * np.abs(ref).max())
