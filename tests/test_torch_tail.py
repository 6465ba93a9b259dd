"""Kernel 4's module: the port's merge tail (through the kernel wrapper,
which takes its plain version on a CPU tensor) against the JAX package's
Pallas `pfnl_tail_pack` (interpret mode) and `_xla_tail_only`, on the CPU,
in float32 and in bf16."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from pfnl_tpu.ops.pallas.pfnl_tail import _xla_tail_only, pfnl_tail_pack
from pfnl_tpu.ops.pallas.pfrb_pack import pad_to_pack_layout, pick_rows

from pfnl_tpu_torch.ops.cuda import launches
from pfnl_tpu_torch.ops.cuda.pfnl_tail import pfnl_tail
from pfnl_tpu_torch.ops.pfrb_ref import compose_d2s4, tail_only_ref

ATOL = 2e-5
N, T, H, W, C = 1, 7, 9, 13, 64
# bf16: the Pallas kernel (and kernel 4's tensor-core entry) rounds m and the output once
# each from float32 sums; the plain version rounds each conv's output and then each bias
# add to bf16.  The case below gives 1.05 bf16 ulps (2^-8) of max|Pallas| on the CPU; a
# wrong tap, frame or bias gives O(1).
BF16_ULPS = 4


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(13)
    feat = (rng.standard_normal((N, T, H, W, C)) * 0.1).astype(np.float32)
    wm1 = (rng.standard_normal((3, 3, T * C, 48)) * 0.05).astype(np.float32)
    bm1 = (rng.standard_normal(48) * 0.1).astype(np.float32)
    km2 = (rng.standard_normal((3, 3, 12, 12)) * 0.05).astype(np.float32)
    bm2 = (rng.standard_normal(12) * 0.1).astype(np.float32)
    jw = [jnp.asarray(a) for a in (wm1, bm1, km2, bm2)]
    packed = pad_to_pack_layout(jnp.asarray(feat), rows=pick_rows(H))
    want = {
        "folded": np.asarray(pfnl_tail_pack(packed, *jw, t=T, h=H, w=W, rows=pick_rows(H))),
        "hr": np.asarray(_xla_tail_only(jnp.asarray(feat), *jw)),
    }
    args = [torch.from_numpy(a) for a in (feat, wm1, bm1, km2, bm2)]
    packed16 = pad_to_pack_layout(jnp.asarray(feat, jnp.bfloat16), rows=pick_rows(H))
    want["bf16"] = np.asarray(pfnl_tail_pack(packed16, *jw, t=T, h=H, w=W, rows=pick_rows(H))
                              .astype(jnp.float32))
    return args, want


def test_tail_matches_pallas_folded_map(case):
    args, want = case
    before = sum(launches.values())
    got = pfnl_tail(*args)
    assert tuple(got.shape) == (N, H, W, 48)
    np.testing.assert_allclose(got.numpy(), want["folded"], atol=ATOL)
    assert sum(launches.values()) == before  # no kernel launch on the CPU


def test_tail_composed_matches_xla_tail(case):
    args, want = case
    np.testing.assert_allclose(compose_d2s4(pfnl_tail(*args)).numpy(), want["hr"], atol=ATOL)


def test_unfolded_tail_matches_xla_tail(case):
    args, want = case
    np.testing.assert_allclose(tail_only_ref(*args).numpy(), want["hr"], atol=ATOL)


def test_bf16_tail_matches_pallas_folded_map(case):
    """The plain tail in bf16 (feat bf16, weights cast at use) against
    pfnl_tail_pack on bf16 input in interpret mode, within BF16_ULPS."""
    args, want = case
    got = pfnl_tail(args[0].bfloat16(), *args[1:])
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (N, H, W, 48)
    ulp = 2.0 ** -8 * np.abs(want["bf16"]).max()
    assert np.abs(got.float().numpy() - want["bf16"]).max() <= BF16_ULPS * ulp
