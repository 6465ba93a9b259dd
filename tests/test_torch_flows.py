"""The flow nets (models/flows.py) and the ops under them against the JAX
package, on the CPU: colour conversions, the `_PS` shuffle, the bilinear
resize, TF-SAME strided and transposed convs, PReLU, the ConvLSTM cell,
EasyFlow and LTDFlow.  Weights are seeded numpy draws bridged into both
(`random_params`), every bias and PReLU slope non-zero."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from pfnl_tpu.models.blocks import PReLU as JPReLU
from pfnl_tpu.models.flows import EasyFlow as JEasyFlow, LTDFlow as JLTDFlow
from pfnl_tpu.ops import color as jcolor
from pfnl_tpu.ops import resize as jresize
from pfnl_tpu.ops import shuffle as jshuffle
from pfnl_tpu.ops.convlstm import ConvLSTMCell as JConvLSTMCell

from pfnl_tpu_torch.models.blocks import PReLU
from pfnl_tpu_torch.models.flows import EasyFlow, LTDFlow
from pfnl_tpu_torch.ops import color, resize, shuffle
from pfnl_tpu_torch.ops.conv import conv2d_same, conv_transpose_same2
from pfnl_tpu_torch.ops.convlstm import ConvLSTMCell
from pfnl_tpu_torch.utils.weights import from_flax


def random_params(module, args, rng, **kwargs):
    """The flax params tree of `module` applied to `args`, drawn from rng:
    kernels N(0, 1/fan_in), biases and PReLU slopes N(0, 0.1^2) (flax
    initialises those to zero, which would hide a bias bug).  Shapes come
    from `jax.eval_shape`, so nothing runs."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))

    def draw(path, leaf):
        name = getattr(path[-1], "key", str(path[-1]))
        if name in ("bias", "alpha"):
            return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return (rng.standard_normal(leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes["params"])


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_color_matches_jax():
    x = np.random.default_rng(0).random((2, 3, 5, 7, 3)).astype(np.float32)
    for name in ("rgb2y", "rgb2ycbcr", "ycbcr2rgb"):
        got = getattr(color, name)(_t(x)).numpy()
        want = np.asarray(getattr(jcolor, name)(jnp.asarray(x)))
        np.testing.assert_allclose(got, want, atol=1e-6, err_msg=name)
        assert getattr(color, name)(_t(x).bfloat16()).dtype == torch.bfloat16
    y = x[..., :1]
    assert torch.equal(color.rgb2y(_t(y)), _t(y))


def test_pixel_shuffle_legacy_matches_jax():
    x = np.random.default_rng(1).standard_normal((2, 3, 5, 16)).astype(np.float32)
    got = shuffle.pixel_shuffle_legacy(_t(x), 2, 4).numpy()
    np.testing.assert_array_equal(got, np.asarray(jshuffle.pixel_shuffle_legacy(
        jnp.asarray(x), 2, 4)))
    np.testing.assert_array_equal(got, shuffle.depth_to_space(_t(x), 2).numpy())


@pytest.mark.parametrize("shape,size", [((2, 6, 10, 3), (24, 40)), ((1, 2, 9, 13, 32), (36, 52))])
def test_resize_bilinear_matches_jax(shape, size):
    x = np.random.default_rng(2).random(shape).astype(np.float32)
    got = resize.resize_bilinear(_t(x), size).numpy()
    np.testing.assert_allclose(got, np.asarray(jresize.resize_bilinear(jnp.asarray(x), size)),
                               atol=1e-6)


@pytest.mark.parametrize("hw,k,stride", [((8, 12), 5, 2), ((9, 7), 3, 2), ((10, 6), 5, 2),
                                         ((7, 9), 9, 1), ((6, 8), 4, 1)])
def test_conv2d_same_matches_lax(hw, k, stride):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2,) + hw + (5,)).astype(np.float32)
    w = (rng.standard_normal((k, k, 5, 6)) / np.sqrt(k * k * 5)).astype(np.float32)
    want = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(w), (stride, stride), "SAME",
                                        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_allclose(conv2d_same(_t(x), _t(w), stride).numpy(), np.asarray(want),
                               atol=1e-5)


@pytest.mark.parametrize("hw", [(5, 7), (4, 4)])
def test_conv_transpose_same2_matches_lax(hw):
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2,) + hw + (6,)).astype(np.float32)
    w = (rng.standard_normal((4, 4, 6, 3)) / np.sqrt(4 * 4 * 6)).astype(np.float32)
    want = jax.lax.conv_transpose(jnp.asarray(x), jnp.asarray(w), (2, 2), "SAME",
                                  dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = conv_transpose_same2(_t(x), _t(w)).numpy()
    assert got.shape == (2, 2 * hw[0], 2 * hw[1], 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


def test_prelu_matches_flax():
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 4, 5, 8)).astype(np.float32)
    params = random_params(JPReLU(channels=8), (jnp.asarray(x),), rng)
    want = JPReLU(channels=8).apply({"params": params}, jnp.asarray(x))
    m = PReLU(8)
    m.load_state_dict(from_flax(params))
    with torch.no_grad():
        np.testing.assert_allclose(m(_t(x)).numpy(), np.asarray(want), atol=1e-6)


def test_convlstm_matches_flax():
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 5, 6, 8)).astype(np.float32)
    c, h = (rng.standard_normal((2, 5, 6, 4)).astype(np.float32) for _ in range(2))
    jm = JConvLSTMCell(4)
    state = (jnp.asarray(c), jnp.asarray(h))
    params = random_params(jm, (state, jnp.asarray(x)), rng)
    (jc, jh), jy = jm.apply({"params": params}, state, jnp.asarray(x))
    m = ConvLSTMCell(8, 4)
    m.load_state_dict(from_flax(params))
    with torch.no_grad():
        (tc, th), ty = m((_t(c), _t(h)), _t(x))
    for got, want in ((tc, jc), (th, jh), (ty, jy)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("net,jnet", [(EasyFlow, JEasyFlow), (LTDFlow, JLTDFlow)])
def test_flow_net_matches_flax(net, jnet):
    """Flows within 1e-5 on the plain branch; h, w multiples of 4."""
    rng = np.random.default_rng(7)
    a, b = (rng.random((3, 12, 16, 1)).astype(np.float32) for _ in range(2))
    jm = jnet(impl="plain")
    params = random_params(jm, (jnp.asarray(a), jnp.asarray(b)), rng)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(a), jnp.asarray(b)))
    m = net()
    m.load_state_dict(from_flax(params))
    with torch.no_grad():
        got = m(_t(a), _t(b)).numpy()
    assert got.shape == (3, 12, 16, 2) and np.abs(want).max() > 0.1
    np.testing.assert_allclose(got, want, atol=1e-5)
