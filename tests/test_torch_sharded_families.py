"""`parallel/spmd.sharded_forward` on VESPCN, MCResNet, LTDVSR and FRVSR:
overlapped row bands (FRVSR: one step's, with the previous estimate's
rows gathered from the bands that own them), on the CPU (a device may
appear more than once, so ["cpu"] * 4 is a data 2 x space 2 mesh).

Each family, on seeded flax weights carried across (every bias and PReLU
slope non-zero), is held (a) to the port's own unsharded forward within
PORT_TOL at (1, 2), (2, 2) and (1, 4), the last with uneven bands thinner
than the halo; (b) once to JAX's unsharded `model.apply(...)["sr"]`, the
JAX splats running the Pallas kernel in interpret mode (JAX's GSPMD
`sharded_forward` does not compute it for these families: its Pallas
splat is a per-chip program); (c) with half the halo, to show that the
band-edge rows then miss; (d) LTDVSR at heights that are not a multiple
of 4, bitwise the unsharded forward and within 2e-5 of JAX's.  Also the
geometry: `row_bands`' alignment and raises, `gather_rows` across several
bands, the refusals.
DRVSR and DUF are in test_torch_sharded_drvsr_duf.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

torch.set_num_threads(2)

from pfnl_tpu.models.frvsr import FRVSR as JFRVSR
from pfnl_tpu.models.ltdvsr import LTDVSR as JLTDVSR
from pfnl_tpu.models.mcresnet import MCResNet as JMCResNet
from pfnl_tpu.models.vespcn import VESPCN as JVESPCN

from pfnl_tpu_torch.models import FRVSR, LTDVSR, MCResNet, VESPCN
from pfnl_tpu_torch.ops.cuda import launches
from pfnl_tpu_torch.parallel import spmd
from pfnl_tpu_torch.parallel.spmd import (extents, gather_rows, row_bands, row_geometry,
                                          sharded_forward)
from pfnl_tpu_torch.utils.weights import from_flax
from tests.test_torch_flows import random_params

PORT_TOL = 1e-5   # against the port's unsharded forward (the same ops on fewer rows)
LAYOUTS = [(1, 2), (2, 2), (1, 4)]

# family -> (port class, JAX class, constructor arguments, LR input [N,T,h,w,3], tolerance
# against JAX's unsharded forward: SR_ATOL of tests/test_torch_yfamily.py, FRVSR's atol of
# tests/test_torch_frvsr.py).  The heights give two bands that each take their full halo
# and, at space 4, uneven bands thinner than the halo (VESPCN 36, 36, 32, 32 rows against
# 48; LTDVSR 28, 24, 24, 24 against 28; FRVSR 48, 48, 40, 44 against 80, a height that is
# not a multiple of 8, so the flow net's pools floor and it resizes 176 -> 180)
FAMILIES = {
    "vespcn": (VESPCN, JVESPCN, {"num_frames": 3}, (2, 3, 136, 16, 3), 2e-5),
    "mcresnet": (MCResNet, JMCResNet, {"num_frames": 5}, (2, 5, 136, 16, 3), 2e-5),
    "ltdvsr": (LTDVSR, JLTDVSR, {"num_frames": 5}, (2, 5, 100, 16, 3), 2e-5),
    "frvsr": (FRVSR, JFRVSR, {"num_frames": 4, "mf": 16, "num_blocks": 2},
              (2, 4, 180, 16, 3), 1e-5),
}
_CASES = {}


def build_case(port_cls, jax_cls, kwargs, shape, seed, variables=None):
    """(port model, x, its unsharded SR, JAX's unsharded SR) on one set of
    seeded weights: `random_params` unless `variables` (a function of the
    flax model and x) draws them."""
    x = np.random.default_rng(seed).random(shape).astype(np.float32)
    jm = jax_cls(**kwargs)
    if variables is None:
        variables = {"params": random_params(jm, (jnp.asarray(x),),
                                             np.random.default_rng(seed + 1))}
    else:
        variables = variables(jm, x)
    want_jax = np.asarray(jax.jit(lambda v, a: jm.apply(v, a)["sr"])(variables, jnp.asarray(x)))
    model = port_cls(**kwargs)
    model.load_state_dict(from_flax(variables["params"], variables.get("batch_stats")))
    model.eval()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out = model(xt)
    return model, xt, out if torch.is_tensor(out) else out["sr"], want_jax


def _case(family):
    if family not in _CASES:
        port_cls, jax_cls, kwargs, shape, _ = FAMILIES[family]
        _CASES[family] = build_case(port_cls, jax_cls, kwargs, shape, seed=len(_CASES) + 1)
    return _CASES[family]


def check_layout(model, x, want, data, space):
    """sharded_forward at data x space against the unsharded SR, PORT_TOL."""
    before = sum(launches.values())
    got = sharded_forward(model, ["cpu"] * (data * space), space=space)(x)
    assert sum(launches.values()) == before  # a CPU tensor launches no kernel
    assert got.shape == want.shape and got.dtype == torch.float32
    err = (got - want).abs().max().item()
    print(f"{type(model).__name__} data {data} x space {space}: max |sharded - unsharded| "
          f"{err:.3e}, bitwise {torch.equal(got, want)}")
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=PORT_TOL, rtol=0)


def check_half_halo_misses(model, x, want, monkeypatch, tol=PORT_TOL):
    """At space 2 with half the table's halo (rounded down to the alignment),
    where the full halo is bitwise, the SR misses `tol` and differs only at
    rows within the halo of the band edge."""
    geo = row_geometry(model)
    half = geo.halo // 2 // geo.align * geo.align
    assert torch.equal(sharded_forward(model, ["cpu"] * 2, space=2)(x), want)
    monkeypatch.setattr(spmd, "row_geometry", lambda m: geo._replace(halo=half))
    got = sharded_forward(model, ["cpu"] * 2, space=2)(x)
    err = (got - want).abs().amax(dim=(0, 1, 3, 4))          # per HR row
    edge = row_bands(x.shape[2], 2, geo.align, geo.ragged)[0][1]
    moved = torch.nonzero(err > 0).flatten() // (got.shape[2] // x.shape[2])   # LR rows
    print(f"{type(model).__name__} halo {half} of {geo.halo}: max err {err.max().item():.3e}, "
          f"LR rows {moved.min().item()}..{moved.max().item()} differ, band edge at {edge}")
    assert err.max() > tol
    assert (moved - edge).abs().max() < geo.halo


@pytest.mark.parametrize("data,space", LAYOUTS, ids=[f"{d}x{s}" for d, s in LAYOUTS])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_forward_matches_the_unsharded_forward(family, data, space):
    model, x, want, _ = _case(family)
    check_layout(model, x, want, data, space)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_forward_matches_jax_unsharded_apply(family):
    model, x, _, want_jax = _case(family)
    got = sharded_forward(model, ["cpu"] * 4, space=4)(x)
    np.testing.assert_allclose(got.numpy(), want_jax, atol=FAMILIES[family][4], rtol=0)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_half_the_halo_misses_at_the_band_edges(family, monkeypatch):
    """FRVSR: with these weights the flow net's rows 40 to 80 from a band's
    own weigh about 2e-6 in the SR, so its SR differs at the band-edge rows
    (where the full halo is bitwise) and its flow there misses PORT_TOL
    (test_frvsr_flow_misses_with_half_the_halo)."""
    model, x, want, _ = _case(family)
    check_half_halo_misses(model, x, want, monkeypatch, 0.0 if family == "frvsr" else PORT_TOL)


def test_frvsr_flow_misses_with_half_the_halo():
    """The flow of one step on the second band's rows and half the halo,
    against the whole image's at the band's own rows: the rows next to the
    edge miss PORT_TOL; with the full halo they are bitwise."""
    model, x, _, _ = _case("frvsr")
    geo = row_geometry(model)
    h = x.shape[2]
    r0 = row_bands(h, 2, geo.align, geo.ragged)[1][0]
    with torch.no_grad():
        whole = model.flow(x[:, 1], x[:, 0])[:, r0:]
        for halo, missed in ((geo.halo, False), (geo.halo // 2, True)):
            e0 = r0 - halo
            band = model.flow(x[:, 1, e0:], x[:, 0, e0:], rows=(h, e0))[:, halo:]
            err = (band - whole).abs().amax(dim=(0, 2, 3))
            print(f"FRVSR flow, halo {halo}: max err {err.max().item():.3e} at LR row "
                  f"{r0 + int(err.argmax())}")
            assert (err.max() > PORT_TOL) == missed
            assert missed or err.max() == 0


# LR heights that are not a multiple of 4: LTDVSR's pools floor and its flow net resizes
# h // 4 -> h (at space 4, 30 rows make bands of 8, 8, 8, 6 and 33 rows 8, 8, 8, 9)
LTDVSR_RAGGED_ROWS = (30, 33)


def _ltdvsr_ragged_case(rows):
    key = ("ltdvsr", rows)
    if key not in _CASES:
        _CASES[key] = build_case(LTDVSR, JLTDVSR, {"num_frames": 5}, (1, 5, rows, 16, 3),
                                 seed=20 + rows)
    return _CASES[key]


@pytest.mark.parametrize("space", (2, 4))
@pytest.mark.parametrize("rows", LTDVSR_RAGGED_ROWS)
def test_ltdvsr_sharded_forward_at_any_height(rows, space):
    """The bottom band takes the rows past the last multiple of 4, and every
    band its rows of the whole image's resize back from the pools: bitwise
    the port's unsharded forward, within JAX's tolerance of its apply."""
    model, x, want, want_jax = _ltdvsr_ragged_case(rows)
    got = sharded_forward(model, ["cpu"] * space, space=space)(x)
    print(f"LTDVSR {rows} rows, space {space}: bands {row_bands(rows, space, 4, True)}, max "
          f"|sharded - JAX| {np.abs(got.numpy() - want_jax).max():.3e}")
    assert torch.equal(got, want)
    np.testing.assert_allclose(got.numpy(), want_jax, atol=FAMILIES["ltdvsr"][4], rtol=0)


def test_geometry_of_each_family():
    """The table's (align, halo, ragged), functions of the configuration."""
    assert row_geometry(VESPCN()) == (4, 48, False)
    assert row_geometry(MCResNet()) == (4, 48, False)
    assert row_geometry(LTDVSR()) == (4, 28, True)
    assert row_geometry(FRVSR()) == (8, 96, True)
    assert row_geometry(FRVSR(mf=16, num_blocks=2)) == (8, 80, True)


def test_row_bands_aligned_and_ragged():
    assert row_bands(136, 4, 4) == [(0, 36), (36, 72), (72, 104), (104, 136)]
    assert row_bands(180, 4, 8, ragged=True) == [(0, 48), (48, 96), (96, 136), (136, 180)]
    assert row_bands(180, 1, 8, ragged=True) == [(0, 180)]
    assert row_bands(30, 4, 1) == [(0, 8), (8, 16), (16, 23), (23, 30)]
    assert extents(row_bands(136, 4, 4), 136, 48) == [(0, 84), (0, 120), (24, 136), (56, 136)]
    with pytest.raises(ValueError, match="evenly into bands of multiples of 4"):
        row_bands(130, 2, 4)
    with pytest.raises(ValueError, match="fewer than 4 bands"):
        row_bands(20, 4, 8, ragged=True)


def test_gather_rows_spans_several_bands():
    """A halo wider than a band: the rows come from every band that holds them."""
    rows = row_bands(24, 4, 2)                                 # 6 rows a band
    bands = [(r0, torch.arange(r0, r1).view(1, -1, 1)) for r0, r1 in rows]
    assert gather_rows(bands, 3, 20, "cpu").flatten().tolist() == list(range(3, 20))
    assert gather_rows(bands, 6, 12, "cpu").flatten().tolist() == list(range(6, 12))
    with pytest.raises(ValueError, match="not all held"):
        gather_rows(bands[:2], 0, 14, "cpu")


def test_sharded_forward_refuses_what_it_cannot_shard():
    model, x, _, _ = _case("vespcn")
    with pytest.raises(ValueError, match="evenly into bands of multiples of 4"):
        sharded_forward(model, ["cpu"] * 2, space=2)(x[:, :, :134])   # not a multiple of A
    with pytest.raises(ValueError, match="fewer than 2 bands"):
        sharded_forward(model, ["cpu"] * 2, space=2)(x[:, :, :4])     # one aligned group
    with pytest.raises(NotImplementedError, match="the seven families"):
        sharded_forward(nn.Conv2d(1, 1, 1), ["cpu"] * 2, space=2)
