"""Kernels 2 and 3's module: the port's PFRB (through the kernel wrappers,
which take their plain versions on a CPU tensor) against the JAX package's
packed Pallas chain (interpret mode) and its XLA chain, on the CPU."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from pfnl_tpu.ops.pallas.pfrb_pack import _chain_pack_run, pfrb_chain_pack, unpad_from_pack_layout
from pfnl_tpu.ops.pallas.pfrb_xla import pfrb_chain_xla

from pfnl_tpu_torch.ops.cuda import launches
from pfnl_tpu_torch.ops.cuda.pfrb import pfrb_a, pfrb_b, pfrb_block
from pfnl_tpu_torch.ops.pfrb_ref import leaky_relu, pfrb_chain_ref

ATOL = 2e-5
N, T, H, W, C = 1, 7, 10, 18, 64
SHAPES = [(3, 3, C, C), (C,), (T, C, C), (C,), (3, 3, C, C), (3, 3, C, C), (C,)]


@pytest.fixture(scope="module")
def case():
    rng = np.random.default_rng(11)
    params = [tuple((rng.standard_normal(s) * 0.05).astype(np.float32) for s in SHAPES)
              for _ in range(2)]
    feat = (rng.standard_normal((N, T, H, W, C)) * 0.1).astype(np.float32)
    jparams = [tuple(jnp.asarray(a) for a in p) for p in params]
    want = {}
    for nb in (1, 2):
        want["pallas", nb] = np.asarray(pfrb_chain_pack(jnp.asarray(feat), jparams[:nb]))
        want["xla", nb] = np.asarray(pfrb_chain_xla(jnp.asarray(feat), jparams[:nb]))
    # kernel A's own outputs for block 0: i1 and base on the packed grid
    _, (_, i1s, bases) = _chain_pack_run(jnp.asarray(feat), jparams[:1], collect=True)
    want["i1"] = np.asarray(unpad_from_pack_layout(i1s[0][:, :T], H, W, col0=1))
    want["base"] = np.asarray(unpad_from_pack_layout(bases[0][:, None], H, W, col0=1))[:, 0]
    tparams = [tuple(torch.from_numpy(a) for a in p) for p in params]
    return torch.from_numpy(feat), tparams, want


@pytest.mark.parametrize("nb", [1, 2])
@pytest.mark.parametrize("ref", ["pallas", "xla"])
def test_pfrb_blocks_match_jax(case, nb, ref):
    feat, params, want = case
    before = sum(launches.values())
    out = feat
    for p in params[:nb]:
        out = pfrb_block(out, *p)
    np.testing.assert_allclose(out.numpy(), want[ref, nb], atol=ATOL)
    np.testing.assert_allclose(pfrb_chain_ref(feat, params[:nb]).numpy(), want[ref, nb],
                               atol=ATOL)
    assert sum(launches.values()) == before  # no kernel launch on the CPU


def test_kernel_a_outputs_match_pallas(case):
    """i1 and base of the first block, each against Pallas kernel A."""
    feat, params, want = case
    i1, base = pfrb_a(feat, *params[0][:4])
    np.testing.assert_allclose(i1.numpy(), want["i1"], atol=ATOL)
    np.testing.assert_allclose(base.numpy(), want["base"], atol=ATOL)
    out = pfrb_b(feat, i1, base, *params[0][4:])
    np.testing.assert_allclose(out.numpy(), want["pallas", 1], atol=ATOL)


# bf16: the Pallas kernels take bf16 activations and weights, sum in float32 and round i1,
# base and out to bf16; the plain versions round after every op (conv, bias add, fusion
# einsum).  This case gives 5.7e-3 (i1), 5.0e-3 (base) and 8.4e-3 (out) of max|ref| on
# the CPU, so 2e-2 (about 5 bf16 ulps of 2^-8) holds with room, and a wrong tap or bias
# gives O(1).
BF16_TOL = 2e-2


@pytest.fixture(scope="module")
def bf16_case():
    rng = np.random.default_rng(13)
    params = tuple((rng.standard_normal(s) * 0.05).astype(np.float32) for s in SHAPES)
    feat = (rng.standard_normal((N, T, H, W, C)) * 0.5).astype(np.float32)
    out, (_, i1s, bases) = _chain_pack_run(jnp.asarray(feat).astype(jnp.bfloat16),
                                           [tuple(jnp.asarray(a) for a in params)], collect=True)
    f32 = lambda x: np.asarray(x.astype(jnp.float32))  # noqa: E731
    want = {"i1": f32(unpad_from_pack_layout(i1s[0][:, :T], H, W, col0=1)),
            "base": f32(unpad_from_pack_layout(bases[0][:, None], H, W, col0=1))[:, 0],
            "out": f32(out)}
    return torch.from_numpy(feat).bfloat16(), [torch.from_numpy(a) for a in params], want


def test_bf16_plain_versions_match_pallas_kernels(bf16_case):
    """Kernels A and B's plain versions in bf16 (through the wrappers, which
    take them on a CPU tensor) against the Pallas kernels in bf16, interpret
    mode: i1, base and out each within BF16_TOL of max|Pallas|."""
    feat, p, want = bf16_case
    i1, base = pfrb_a(feat, *p[:4])
    out = pfrb_b(feat, i1, base, *p[4:])
    for name, got in (("i1", i1), ("base", base), ("out", out)):
        assert got.dtype == torch.bfloat16
        ref = want[name]
        err = np.abs(got.float().numpy() - ref).max()
        assert err <= BF16_TOL * np.abs(ref).max(), (name, err)


def test_bf16_base_rounds_once_where_pallas_rounds_per_frame_group(bf16_case):
    """The known difference, named: Pallas kernel A rounds the partial
    fusion sum to bf16 at every frame-group boundary (tb = 4, so after
    frames 0-3 at T = 7; pfrb_pack.py:147-153), the port's kernel A sums
    all T frames in float32 registers and rounds `base` once.  From
    Pallas's own i1, that one-rounding base is within 2 bf16 ulps of
    max|base| of Pallas's (1.29 ulps in this case on the CPU), so the port
    keeps the single rounding."""
    _, p, want = bf16_case
    i1 = torch.from_numpy(want["i1"].copy())
    fused = torch.einsum("nthwc,tcd->nhwd", i1, p[2].bfloat16().float())
    base = leaky_relu(fused + p[3]).bfloat16().float().numpy()
    ulp = 2.0 ** -8 * np.abs(want["base"]).max()
    assert np.abs(base - want["base"]).max() <= 2 * ulp
