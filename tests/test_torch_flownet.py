"""FlowNet-S, FlowNet-C, the correlation layer, the warp-confidence net, the
Caffe import and the flow tools of the port against the JAX package, on the
CPU, with weights carried across by `from_flax`.  float32 on both sides:
a flow within 1e-4 of the largest |flow| (two decoders of 20 convs each
sum in different orders), the rest as each test states."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from pfnl_tpu.models.flownet import (FlowNetC as JFlowNetC, FlowNetS as JFlowNetS,
                                     WarpConfidence as JWarpConfidence,
                                     correlation as j_correlation)
from pfnl_tpu.ops.resize import resize_bilinear as j_resize_bilinear
from pfnl_tpu.utils import flow_tools as j_flow_tools
from pfnl_tpu.utils.param_io import get_num_params as j_get_num_params
from pfnl_tpu.utils.param_io import load_caffe_flownet as j_load_caffe_flownet

from pfnl_tpu_torch.models.flownet import FlowNetC, FlowNetS, WarpConfidence, correlation
from pfnl_tpu_torch.ops.resize import resize_bilinear
from pfnl_tpu_torch.utils import flow_tools
from pfnl_tpu_torch.utils.param_io import get_num_params, load_caffe_flownet
from pfnl_tpu_torch.utils.weights import from_flax
from tests.test_flownet_tools import _caffe_flownet_weights

HW = (48, 40)  # not multiples of 64: the adapt resize and the rescale run


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _pair(seed, n=1, hw=HW, c=3):
    rng = np.random.default_rng(seed)
    return [rng.random((n,) + hw + (c,)).astype(np.float32) for _ in range(2)]


def _close_flow(got, want, rel=1e-4):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * np.abs(want).max(), np.abs(got - want).max()


@pytest.mark.parametrize("variant", ["s", "c"])
def test_flownet_matches_flax(variant):
    """Every flax parameter name fits the port (load_state_dict strict);
    the flow at 48x40 (resized to 64x64 and back) within 1e-4 of max|flow|."""
    jcls, cls = {"s": (JFlowNetS, FlowNetS), "c": (JFlowNetC, FlowNetC)}[variant]
    a, b = _pair(1)
    jm = jcls()
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(a), jnp.asarray(b))["params"]
    model = cls()
    model.load_state_dict(from_flax(_np_tree(params)))
    assert get_num_params(model) == j_get_num_params(params)
    with torch.no_grad():
        got = model(_t(a), _t(b))
    _close_flow(got, jm.apply({"params": params}, jnp.asarray(a), jnp.asarray(b)))


def test_correlation_matches_jax_at_the_reference_displacements():
    """max_disp 20, stride 2: 441 displacements, most of them past the
    border of a 12x10 map (zero there), divided by 441."""
    a, b = _pair(2, n=2, hw=(12, 10), c=5)
    got = correlation(_t(a), _t(b), max_disp=20, stride=2)
    want = np.asarray(j_correlation(jnp.asarray(a), jnp.asarray(b), max_disp=20, stride=2))
    assert got.shape == want.shape == (2, 12, 10, 441)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    # the centre displacement is the per-pixel channel dot product over 441
    np.testing.assert_allclose(got[..., 220].numpy(), (a * b).sum(-1) / 441, rtol=1e-6)


def _warp_conf_case(rng):
    jm = JWarpConfidence()
    a, b = (rng.random((2, 16, 12, 1)).astype(np.float32) for _ in range(2))
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(a), jnp.asarray(b))
    params = jax.tree_util.tree_map(
        lambda p: np.asarray(p) + rng.normal(0, 0.05, p.shape).astype(np.float32), v["params"])
    stats = jax.tree_util.tree_map(np.asarray, v["batch_stats"])
    stats = {k: {"mean": rng.normal(0, 0.1, s["mean"].shape).astype(np.float32),
                 "var": rng.uniform(0.5, 1.5, s["var"].shape).astype(np.float32)}
             for k, s in stats.items()}
    return jm, params, stats, a, b


def test_warp_confidence_matches_flax_in_both_modes():
    """Eval mode on non-trivial running statistics; training mode (flax
    train=True, mutable=["batch_stats"]) twice: the confidence, and the
    running mean and variance after each update (1e-5)."""
    rng = np.random.default_rng(3)
    jm, params, stats, a, b = _warp_conf_case(rng)
    model = WarpConfidence()
    model.load_state_dict(from_flax(params, stats))
    model.eval()
    with torch.no_grad():
        got = model(_t(a), _t(b))
    want = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert got.shape == (2, 16, 12, 1) and (got >= 0).all() and (got <= 1).all()

    model.train()
    for _ in range(2):
        with torch.no_grad():
            got = model(_t(a), _t(b))
        want, mut = jm.apply({"params": params, "batch_stats": stats}, jnp.asarray(a),
                             jnp.asarray(b), train=True, mutable=["batch_stats"])
        stats = _np_tree(mut["batch_stats"])
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
        for k, v in from_flax({}, stats).items():
            np.testing.assert_allclose(model.state_dict()[k].numpy(), v.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    # the same image on both sides: cosine 1
    model.eval()
    with torch.no_grad():
        np.testing.assert_allclose(model(_t(a), _t(a)).numpy(), 1.0, atol=1e-5)


def test_caffe_import_matches_jax_import_and_forward(capsys):
    """Synthetic Caffe blobs for FlowNet-C: every parameter replaced, each
    one equal to JAX's import of the same blobs, and the forward with them
    against flax's (1e-4 of max|flow|); an unmatched layer and a misfit
    shape are left out with a warning naming them."""
    rng = np.random.default_rng(0)
    caffe = _caffe_flownet_weights(rng, variant="c")
    a, b = _pair(4)
    jm = JFlowNetC()
    jparams = j_load_caffe_flownet(
        jm.init(jax.random.PRNGKey(0), jnp.asarray(a), jnp.asarray(b))["params"], caffe,
        verbose=False)
    model = FlowNetC()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    loaded = load_caffe_flownet(model.state_dict(), caffe, verbose=False)
    want = from_flax(_np_tree(jparams))
    assert set(loaded) == set(want) and len(loaded) == 2 * len(caffe)
    for k, v in loaded.items():
        assert not torch.equal(v, before[k]), k
        assert torch.equal(v, want[k]), k
    model.load_state_dict(loaded)
    with torch.no_grad():
        got = model(_t(a), _t(b))
    _close_flow(got, jm.apply({"params": jparams}, jnp.asarray(a), jnp.asarray(b)))

    extra = dict(caffe, conv9=caffe["conv1"], conv2=(caffe["conv1"][0], caffe["conv2"][1]))
    load_caffe_flownet(model.state_dict(), extra)
    out = capsys.readouterr().out
    assert "Cant find param: conv9 (kernel)" in out and "conv9 (bias)" in out
    assert "conv2 (kernel shape (7, 7, 3, 64) != (5, 5, 64, 128))" in out
    assert f"Caffe params loaded ({2 * len(caffe) - 1}/{len(loaded)} leaves)" in out


def test_resize_align_corners_matches_jax():
    x = np.random.default_rng(5).random((2, 7, 9, 3)).astype(np.float32)
    for size in ((64, 64), (3, 4)):
        got = resize_bilinear(_t(x), size, mapping="align_corners")
        want = j_resize_bilinear(jnp.asarray(x), size, mapping="align_corners")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    # the corners are kept
    np.testing.assert_allclose(got[:, [0, -1]][:, :, [0, -1]].numpy(),
                               x[:, [0, -1]][:, :, [0, -1]], rtol=1e-6)


def test_flow_tools_copy_matches_the_original(tmp_path):
    rng = np.random.default_rng(6)
    flow = rng.standard_normal((6, 8, 2)).astype(np.float32) * 3
    gt = flow + rng.standard_normal(flow.shape).astype(np.float32) * 0.2
    flow_tools.write_flo(str(tmp_path / "a.flo"), flow)
    j_flow_tools.write_flo(str(tmp_path / "b.flo"), flow)
    assert (tmp_path / "a.flo").read_bytes() == (tmp_path / "b.flo").read_bytes()
    np.testing.assert_array_equal(flow_tools.read_flo(str(tmp_path / "b.flo")), flow)
    assert flow_tools.flow_epe(flow, gt) == j_flow_tools.flow_epe(flow, gt)
    assert flow_tools.flow_aae(flow, gt) == j_flow_tools.flow_aae(flow, gt)
    np.testing.assert_array_equal(flow_tools._make_colorwheel(), j_flow_tools._make_colorwheel())
    for max_flow in (None, 2.0):
        np.testing.assert_array_equal(flow_tools.flow_to_color(flow, max_flow),
                                      j_flow_tools.flow_to_color(flow, max_flow))
    with pytest.raises(ValueError, match="bad .flo magic"):
        (tmp_path / "c.flo").write_bytes(b"\0" * 16)
        flow_tools.read_flo(str(tmp_path / "c.flo"))
