"""`parallel/spmd.sharded_forward` on DRVSR (its full form: SPMC, kernel 8
on the card, and a ConvLSTM step a frame) and DUF-16L (kernel 9 for the
dense blocks on the card, or kernel 10 per growth conv), on the CPU: the
checks of test_torch_sharded_families.py, (a) against the port's
unsharded forward at three layouts, (b) once against JAX's unsharded
`model.apply(...)["sr"]`, (c) half the halo, in a file of their own (JAX's
DRVSR compiles the SPMC splat's Pallas kernel in interpret mode, and flax
DUF is slow to trace)."""

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pfnl_tpu.models.drvsr import DRVSR as JDRVSR
from pfnl_tpu.models.duf import DUF as JDUF

from pfnl_tpu_torch.models import DRVSR, DUF
from pfnl_tpu_torch.parallel.spmd import row_geometry, sharded_forward
from tests.test_torch_duf import duf_variables
from tests.test_torch_sharded_families import (LAYOUTS, PORT_TOL, build_case, check_half_halo_misses,
                                               check_layout)

# DRVSR: 104 rows, 28, 28, 24, 24 at space 4 against a halo of 40; DUF-16L: 30 rows, 8, 8,
# 7, 7 against 8.  Tolerances against JAX: SR_ATOL of tests/test_torch_yfamily.py; DUF's
# rtol / atol of tests/test_torch_duf.py
FAMILIES = {
    "drvsr": (DRVSR, JDRVSR, {"num_frames": 3}, (2, 3, 104, 16, 3), {"atol": 2e-5, "rtol": 0}),
    "duf": (DUF, JDUF, {"num_frames": 7, "layers": 16}, (2, 7, 30, 16, 3),
            {"atol": 1e-5, "rtol": 1e-4}),
}
_CASES = {}


def _case(family):
    if family not in _CASES:
        port_cls, jax_cls, kwargs, shape, _ = FAMILIES[family]
        seed = 11 + len(_CASES)
        variables = None
        if family == "duf":
            variables = lambda jm, x: duf_variables(jm, x, np.random.default_rng(seed))  # noqa: E731
        _CASES[family] = build_case(port_cls, jax_cls, kwargs, shape, seed, variables)
    return _CASES[family]


@pytest.mark.parametrize("data,space", LAYOUTS, ids=[f"{d}x{s}" for d, s in LAYOUTS])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_forward_matches_the_unsharded_forward(family, data, space):
    model, x, want, _ = _case(family)
    check_layout(model, x, want, data, space)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_sharded_forward_matches_jax_unsharded_apply(family):
    model, x, _, want_jax = _case(family)
    got = sharded_forward(model, ["cpu"] * 4, space=4)(x)
    np.testing.assert_allclose(got.numpy(), want_jax, **FAMILIES[family][4])


@pytest.mark.parametrize("family", list(FAMILIES))
def test_half_the_halo_misses_at_the_band_edges(family, monkeypatch):
    model, x, want, _ = _case(family)
    check_half_halo_misses(model, x, want, monkeypatch)


def test_duf_kernel_paths_and_geometry():
    """conv3d_impl "fused" and "pallas" (on the CPU the plain versions of
    kernels 9 and 10) shard bitwise; the halo follows the blocks and DRVSR's
    frames; a training-mode DUF is refused."""
    model, x, want, _ = _case("duf")
    assert row_geometry(model) == (1, 8, False)
    assert row_geometry(DUF(layers=52)) == (1, 26, False)
    assert row_geometry(DRVSR()) == (4, 40, False) and row_geometry(DRVSR(num_frames=5)) == (4, 44, False)
    for impl in ("fused", "pallas"):
        m = DUF(num_frames=7, layers=16, conv3d_impl=impl)
        m.load_state_dict(model.state_dict())
        with torch.no_grad():
            own = m.eval()(x)
        got = sharded_forward(m, ["cpu"] * 2, space=2)(x)
        assert torch.equal(got, own)
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=PORT_TOL, rtol=0)
    with pytest.raises(ValueError, match="eval mode"):
        sharded_forward(m.train(), ["cpu"] * 2, space=2)
