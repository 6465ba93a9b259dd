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
from pfnl_tpu_torch.ops.pfrb_ref import pfrb_chain_ref

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
