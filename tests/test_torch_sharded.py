"""`parallel/spmd.sharded_forward` on PFNL (its image rows over devices,
the halos exchanged by hand after every layer) against the port's
unsharded forward and against the JAX package's GSPMD `sharded_forward`
on the same weights, on the CPU (a device may appear more than once, so
["cpu"] * 8 is a data 2 x space 4 mesh): even bands, uneven bands, the
chunked attention, and the raises, among them a module that is none of
the seven families.  The other six families' overlapped bands are in
test_torch_sharded_families.py and test_torch_sharded_drvsr_duf.py."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch import nn

torch.set_num_threads(2)

from pfnl_tpu.models.pfnl import PFNL as JPFNL
from pfnl_tpu.parallel.mesh import make_mesh as j_make_mesh
from pfnl_tpu.parallel.spmd import sharded_forward as j_sharded_forward

from pfnl_tpu_torch.models.pfnl import PFNL
from pfnl_tpu_torch.parallel.spmd import exchange_halos, row_bands, sharded_forward, with_halo
from pfnl_tpu_torch.utils.weights import from_flax

PORT_TOL = 1e-5   # against the port's unsharded forward (the same ops on fewer rows)
JAX_TOL = 2e-5    # against JAX's sharded_forward: tests/test_parallel.py:87's tolerance


def _nonzero_biases(params, rng):
    """flax's zero biases replaced by small random ones, so that a halo row
    missing at a band edge shows even where activations would be zero."""
    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else
                (rng.normal(0, 0.1, v.shape).astype(np.float32) if "bias" in k else v)
                for k, v in tree.items()}
    return walk(params)


@pytest.fixture(scope="module")
def pfnl_pair():
    """(flax model, variables, the port's model) with the same weights:
    3 frames, mf 64, 2 PFRBs."""
    rng = np.random.default_rng(0)
    jm = JPFNL(num_frames=3, num_blocks=2, pfrb_impl="xla", nonlocal_impl="dense")
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros((1, 3, 16, 16, 3)))
    params = _nonzero_biases(jax.tree_util.tree_map(np.asarray, variables["params"]), rng)
    model = PFNL(num_frames=3, num_blocks=2)
    model.load_state_dict(from_flax(params))
    return jm, {"params": params}, model.eval()


def _x(shape, seed=1):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("data,space,shape", [
    (2, 4, (4, 3, 16, 16, 3)),
    (1, 2, (2, 3, 16, 16, 3)),
    (1, 4, (2, 3, 20, 24, 3)),   # 10 row pairs over 4 bands: 6, 6, 4, 4 rows
    (1, 8, (1, 3, 16, 16, 3)),   # bands of 2 rows: every halo row from a neighbour
])
def test_sharded_forward_matches_the_unsharded_forward(pfnl_pair, data, space, shape):
    _, _, model = pfnl_pair
    x = torch.from_numpy(_x(shape))
    with torch.no_grad():
        want = model(x)
    got = sharded_forward(model, ["cpu"] * (data * space), space=space)(x)
    assert got.shape == want.shape == (shape[0], 1, 4 * shape[2], 4 * shape[3], 3)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=PORT_TOL, rtol=0)


@pytest.mark.parametrize("data,space", [(2, 4), (1, 2)])
def test_sharded_forward_matches_jax_gspmd(pfnl_pair, data, space):
    jm, variables, model = pfnl_pair
    x = _x((4, 3, 16, 16, 3), seed=2)
    want = np.asarray(j_sharded_forward(jm, variables, j_make_mesh(n_data=data, n_space=space))(
        jnp.asarray(x)))
    got = sharded_forward(model, ["cpu"] * (data * space), space=space)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), want, atol=JAX_TOL, rtol=0)


def test_chunked_attention_on_the_bands(pfnl_pair):
    _, _, model = pfnl_pair
    x = torch.from_numpy(_x((2, 3, 20, 24, 3), seed=3))
    with torch.no_grad():
        want = model(x)
    got = sharded_forward(model, ["cpu"] * 4, space=4, impl="chunked")(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=PORT_TOL, rtol=0)


def test_row_bands_are_even_and_differ_by_one_pair_at_most():
    assert row_bands(20, 4) == [(0, 6), (6, 12), (12, 16), (16, 20)]
    assert row_bands(180, 4) == [(0, 46), (46, 92), (92, 136), (136, 180)]
    assert row_bands(16, 8) == [(2 * i, 2 * i + 2) for i in range(8)]
    with pytest.raises(ValueError, match="fewer than 8 bands"):
        row_bands(14, 8)
    with pytest.raises(ValueError, match="even"):
        row_bands(15, 2)


def test_halos_come_from_the_neighbours_and_not_past_the_edges():
    bands = [torch.arange(r0, r1).view(1, -1) for r0, r1 in row_bands(12, 3)]
    ext = with_halo(bands, 2, 1)
    want = [([0, 1, 2, 3, 4, 5], 0, 2), ([2, 3, 4, 5, 6, 7, 8, 9], 2, 2),
            ([6, 7, 8, 9, 10, 11], 2, 0)]
    assert [(e.tolist()[0], top, bot) for e, top, bot in ext] == want
    # a layer's output: own rows + 100, ghost rows wrong (-1); the exchange
    # restores each ghost row from the neighbour's own row there
    outs = []
    for e, top, bot in ext:
        o = e + 100
        o[:, :top] = -1
        o[:, o.shape[1] - bot:] = -1
        outs.append(o)
    exchange_halos(outs, 2, 1)
    assert [o.tolist()[0] for o in outs] == [[v + 100 for v in w[0]] for w in want]


def test_sharded_forward_raises_where_it_cannot_shard(pfnl_pair):
    _, _, model = pfnl_pair
    x = torch.from_numpy(_x((2, 3, 12, 16, 3)))
    with pytest.raises(ValueError, match="fewer than 8 bands"):
        sharded_forward(model, ["cpu"] * 8, space=8)(x)       # H/2 = 6 < 8
    with pytest.raises(ValueError, match="does not split over data=4"):
        sharded_forward(model, ["cpu"] * 8, space=2)(x)       # a batch of 2 over 4
    with pytest.raises(ValueError, match="bands of space=3"):
        sharded_forward(model, ["cpu"] * 4, space=3)
    with pytest.raises(NotImplementedError, match="the seven families"):
        sharded_forward(nn.Conv2d(1, 1, 1), ["cpu"] * 2, space=2)
