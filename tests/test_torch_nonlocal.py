"""Kernel 1's module: the port's non-local attention and NonLocalBlock
against the JAX package (the Pallas kernel in interpret mode), on the CPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from pfnl_tpu.models.blocks import NonLocalBlock as JNonLocalBlock
from pfnl_tpu.ops.nonlocal_attn import nonlocal_attention as j_dense
from pfnl_tpu.ops.pallas.nonlocal_flash import nonlocal_flash as j_flash

from pfnl_tpu_torch.models.blocks import NonLocalBlock
from pfnl_tpu_torch.ops.cuda import launches
from pfnl_tpu_torch.ops.cuda.nonlocal_flash import nonlocal_flash
from pfnl_tpu_torch.ops.nonlocal_attn import nonlocal_attention, nonlocal_attention_chunked
from pfnl_tpu_torch.utils.weights import from_flax

ATOL = 2e-5

TORCH_IMPLS = {
    "dense": nonlocal_attention,
    "chunked": lambda t, p, g: nonlocal_attention_chunked(t, p, g, block=128),
    "kernel_wrapper": nonlocal_flash,   # a CPU tensor takes the plain version
}


def _inputs(b, n, d, seed):
    rng = np.random.default_rng(seed)
    theta = rng.standard_normal((b, n, d)).astype(np.float32)
    g = rng.standard_normal((b, n, d)).astype(np.float32)
    return theta, g


@pytest.fixture(scope="module")
def references():
    """theta = phi (nltype 1) at the PFNL width and a ragged size: JAX's
    Pallas kernel (interpret mode) and its dense attention."""
    out = {}
    for shape in [(2, 256, 84), (1, 300, 30)]:
        theta, g = _inputs(*shape, seed=shape[1])
        args = (jnp.asarray(theta), jnp.asarray(theta), jnp.asarray(g))
        out[shape] = (theta, g, {
            "pallas": np.asarray(j_flash(*args, bq=128, bk=128, interpret=True)),
            "dense": np.asarray(j_dense(*args)),
        })
    return out


@pytest.mark.parametrize("impl", sorted(TORCH_IMPLS))
@pytest.mark.parametrize("shape", [(2, 256, 84), (1, 300, 30)])
@pytest.mark.parametrize("ref", ["pallas", "dense"])
def test_attention_matches_jax(references, impl, shape, ref):
    theta, g, want = references[shape]
    before = sum(launches.values())
    t = torch.from_numpy(theta)
    got = TORCH_IMPLS[impl](t, t, torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(got, want[ref], atol=ATOL)
    assert sum(launches.values()) == before  # no kernel launch on the CPU


@pytest.mark.parametrize("hwc", [(6, 8, 84), (65, 64, 12)])
def test_nonlocal_block_matches_flax(hwc):
    """Dense below 4096 positions, streaming above (65*64 = 4160)."""
    h, w, c = hwc
    x = np.random.default_rng(7).random((1, h, w, c)).astype(np.float32)
    jm = JNonLocalBlock(out_channels=c, nltype=1)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(jm.apply(variables, jnp.asarray(x)))

    block = NonLocalBlock(c)
    block.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray, variables["params"])))
    with torch.no_grad():
        got = block(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=ATOL)


# bf16: the JAX kernel rounds P to bf16 before PV (p.astype(v.dtype)) as the port's bf16
# tensor-core kernel does; the plain version keeps P in float32.  Each term of PV then
# differs by up to 2^-9 relatively, and the output by far less than 1e-2 of max|ref|.
BF16_TOL = 1e-2


@pytest.mark.parametrize("dist", ["normal", "uniform"])
@pytest.mark.parametrize("shape", [(2, 256, 84), (1, 300, 30)])
def test_bf16_plain_matches_jax_kernel(shape, dist):
    """The port's plain version in bf16 against JAX's Pallas kernel in bf16
    (interpret mode), theta = phi: standard normal (scores about 84 on the
    diagonal, a near one-hot softmax) or uniform in [0, 1) as PFNL's
    space-to-depth frames."""
    rng = np.random.default_rng(shape[1] + 1)
    theta = (rng.standard_normal(shape) if dist == "normal" else rng.random(shape))
    g = rng.standard_normal(shape)
    jt, jg = jnp.asarray(theta, jnp.bfloat16), jnp.asarray(g, jnp.bfloat16)
    want = np.asarray(j_flash(jt, jt, jg, bq=128, bk=128, interpret=True).astype(jnp.float32))
    tt, tg = torch.from_numpy(theta).bfloat16(), torch.from_numpy(g).bfloat16()
    got = nonlocal_flash(tt, tt, tg)                  # a CPU tensor: the plain version
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_TOL * np.abs(want).max(), err
