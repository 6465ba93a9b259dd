"""DUF and its serving path against the JAX package, on the CPU.

The ops (`depth_to_space_3d`, `dyn_filter_3d`), `Conv3D` in its three pad
modes and `RefBatchNorm` are held to their flax counterparts; the plain
versions of kernels 9 and 10 (ops/duf_ref.py) to the Pallas kernels
`dense_backbone_fused` and `conv3x3x3_tap` in interpret mode, at the
multi-tile geometry of tests/test_pallas_kernels.py (16L, 1x7x20x12, which
includes the VALID-T blocks); DUF at 16 and 52 layers to flax
DUF(conv3d_impl="xla") through `from_flax(params, batch_stats)` with
non-trivial BatchNorm state, and to the numpy oracle of
tests/test_golden_models.py; the Predictor's PNGs to the JAX Predictor's
within 1 LSB.  float32 on both sides: rtol 1e-4, atol 1e-5 unless a test
says otherwise.  A CPU tensor launches no kernel."""

import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from pfnl_tpu.config import preset
from pfnl_tpu.infer.predictor import Predictor as JPredictor
from pfnl_tpu.models.duf import DUF as JDUF, Conv3D as JConv3D, RefBatchNorm as JRefBatchNorm
from pfnl_tpu.ops import shuffle as jshuffle
from pfnl_tpu.ops.dynfilter import dyn_filter_3d as jdyn_filter_3d
from pfnl_tpu.ops.pallas.duf_block import BlockParams as JBlockParams, dense_backbone_fused
from pfnl_tpu.ops.pallas.duf_dense import conv3x3x3_tap
from pfnl_tpu.utils.image_io import imread

from pfnl_tpu_torch.__main__ import main as cli
from pfnl_tpu_torch.infer.predictor import Predictor
from pfnl_tpu_torch.infer.profile_serving import seeded_model
from pfnl_tpu_torch.models import DUF
from pfnl_tpu_torch.models.duf import Conv3D, RefBatchNorm
from pfnl_tpu_torch.ops.cuda import launches
from pfnl_tpu_torch.ops.cuda.duf_dense import conv3x3x3
from pfnl_tpu_torch.ops.duf_ref import (BlockParams, conv3x3x3_ref, dense_backbone_ref,
                                        dense_block_ref)
from pfnl_tpu_torch.ops.dynfilter import dyn_filter_3d
from pfnl_tpu_torch.ops.shuffle import depth_to_space_3d
from pfnl_tpu_torch.utils.weights import from_flax, load_npz
from tests.test_golden_models import duf_oracle
from tests.util_data import make_dataset

RTOL, ATOL = 1e-4, 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _close(got, want, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def duf_variables(jm, x, rng):
    """flax variables of `jm` applied to x, drawn from rng: W ~ N(0, 2/fan_in),
    every bias and beta N(0, 0.1^2), gamma 1 + N(0, 0.1^2); BatchNorm state
    with moving_mean N(0, 0.1^2), moving_variance U(0.5, 1.5), its zero_debias
    shadows at step 100.  (The init's moving_variance of 0 makes the
    activations about 1e17.)  Shapes come from `jax.eval_shape`."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(x)))

    def param(path, leaf):
        name = path[-1].key
        if name == "W":
            return rng.standard_normal(leaf.shape) * np.sqrt(2.0 / np.prod(leaf.shape[:-1]))
        return (name == "gamma") + rng.standard_normal(leaf.shape) * 0.1

    def stat(path, leaf):
        name = path[-1].key
        if name == "local_step":
            return np.float32(100.0)
        mean = rng.standard_normal(leaf.shape) * 0.1
        var = rng.uniform(0.5, 1.5, leaf.shape)
        return {"moving_mean": mean, "moving_variance": var,
                "biased_mean": mean * (1 - 0.999 ** 100),
                "biased_var": var * (1 - 0.999 ** 100)}[name]

    f32 = lambda fn: lambda p, l: np.asarray(fn(p, l), np.float32)
    return {"params": jax.tree_util.tree_map_with_path(f32(param), shapes["params"]),
            "batch_stats": jax.tree_util.tree_map_with_path(f32(stat), shapes["batch_stats"])}


def _port_duf(variables, **kw):
    model = DUF(**kw)
    model.load_state_dict(from_flax(variables["params"], variables["batch_stats"]))  # strict
    return model.eval()


# ---------------------------------------------------------------- ops and modules

def test_depth_to_space_3d_matches_jax():
    x = np.random.default_rng(0).random((2, 3, 4, 5, 48)).astype(np.float32)
    got = depth_to_space_3d(_t(x), 4)
    assert got.shape == (2, 3, 16, 20, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jshuffle.depth_to_space_3d(x, 4)))


def test_dyn_filter_3d_matches_jax():
    """Zero-padded 5x5 taps, row-major over (i, j), against softmaxed filters."""
    rng = np.random.default_rng(1)
    x = rng.random((2, 1, 9, 11)).astype(np.float32)
    f = rng.standard_normal((2, 9, 11, 25, 16)).astype(np.float32)
    f = np.exp(f) / np.exp(f).sum(3, keepdims=True)
    got = dyn_filter_3d(_t(x), _t(f))
    assert got.shape == (2, 9, 11, 16)
    _close(got, jdyn_filter_3d(jnp.asarray(x), jnp.asarray(f)), atol=1e-6)


@pytest.mark.parametrize("kernel,pad", [((3, 3, 3), "thw"), ((3, 3, 3), "hw"),
                                        ((1, 3, 3), "hw"), ((1, 1, 1), "none"),
                                        ((3, 3, 3), "none")])
def test_conv3d_matches_flax(kernel, pad):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 5, 6, 7, 24)).astype(np.float32)
    jm = JConv3D(16, kernel, in_features=24, pad=pad)
    params = {"W": (rng.standard_normal((*kernel, 24, 16)) * 0.1).astype(np.float32),
              "b": (rng.standard_normal(16) * 0.1).astype(np.float32)}
    m = Conv3D(16, kernel, 24, pad)
    m.load_state_dict(from_flax(params))
    with torch.no_grad():
        got = m(_t(x))
    want = jm.apply({"params": params}, jnp.asarray(x))
    assert got.shape == want.shape
    _close(got, want)


def test_ref_batchnorm_eval_and_folded_match_flax():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 4, 5, 32)).astype(np.float32)
    jm = JRefBatchNorm(32)
    params = {"beta": rng.standard_normal(32) * 0.1, "gamma": 1 + rng.standard_normal(32) * 0.1}
    stats = {"moving_mean": rng.standard_normal(32) * 0.1, "moving_variance": rng.random(32) + 0.5,
             "biased_mean": rng.standard_normal(32), "biased_var": rng.random(32),
             "local_step": np.float32(7.0)}
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    stats = {k: np.asarray(v, np.float32) for k, v in stats.items()}
    m = RefBatchNorm(32)
    m.load_state_dict(from_flax(params, stats))
    m.eval()
    jv = {"params": params, "batch_stats": stats}
    with torch.no_grad():
        _close(m(_t(x)), jm.apply(jv, jnp.asarray(x), False))
        assert m(_t(x).bfloat16()).dtype == torch.bfloat16
        s, o = m.folded()
    js, jo = jm.apply(jv, method=lambda mod: mod.folded())
    _close(s, js)
    _close(o, jo)
    # training mode: batch statistics and one zero_debias update of the buffers, as flax's
    # is_train=True with mutable=["batch_stats"] (tests/test_torch_duf_train.py holds more)
    m.train()
    with torch.no_grad():
        got = m(_t(x))
    want, mut = jm.apply(jv, jnp.asarray(x), True, mutable=["batch_stats"])
    _close(got, want)
    for k, v in mut["batch_stats"].items():
        _close(getattr(m, k), v)


# ---------------------------------------------------------------- kernel 9's plain version

def _blocks(rng, c0=64, g=32, modes=("thw",) * 3 + ("hw",) * 3):
    """numpy block parameters with positive and negative offsets, so that
    relu(oa) and relu(ob) are non-zero where the buffer holds zeros."""
    out, f = [], c0
    for mode in modes:
        out.append(dict(sa=rng.uniform(0.5, 1.5, f), oa=rng.standard_normal(f) * 0.3,
                        wa=rng.standard_normal((f, f)) / np.sqrt(f),
                        sb=rng.uniform(0.5, 1.5, f), ob=rng.standard_normal(f) * 0.3,
                        wb=rng.standard_normal((3, 3, 3, f, g)) / np.sqrt(27 * f),
                        bb=rng.standard_normal(g) * 0.1, mode=mode))
        f += g
    return [{k: v if k == "mode" else np.asarray(v, np.float32) for k, v in b.items()}
            for b in out]


def _torch_blocks(blocks):
    return [BlockParams(**{k: v if k == "mode" else _t(v) for k, v in b.items()}) for b in blocks]


def _jax_blocks(blocks):
    return [JBlockParams(**{k: v if k == "mode" else jnp.asarray(v) for k, v in b.items()})
            for b in blocks]


# 16L's multi-tile geometry (tests/test_pallas_kernels.py:315-332)
X64_SHAPE = (1, 7, 20, 12, 64)


@pytest.mark.parametrize("which", ["thw", "hw", "chain"])
def test_dense_backbone_ref_matches_fused_kernel(which):
    """One SAME-T block, one VALID-T block (T 7 -> 5) and the whole 16L
    chain (T 7 -> 1) against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(4)
    x64 = rng.random(X64_SHAPE).astype(np.float32)
    blocks = _blocks(rng)
    blocks = {"thw": blocks[:1], "hw": _blocks(rng, modes=("hw",)), "chain": blocks}[which]
    want = np.asarray(dense_backbone_fused(jnp.asarray(x64), _jax_blocks(blocks)))
    got = dense_backbone_ref(_t(x64), _torch_blocks(blocks))
    assert got.shape == want.shape
    _close(got, want)


@pytest.mark.parametrize("which", ["thw", "hw"])
def test_dense_backbone_ref_bf16_matches_fused_kernel(which):
    """In bf16: the plain kernel 9 rounds where the Pallas kernel does
    (relu(sa*x+oa) and `a` to bf16, float32 sums, the new channels once), as
    kernel 9's tensor-core entry does.  One SAME-T and one VALID-T block (T 7
    -> 5) at X64_SHAPE against the Pallas kernel in interpret mode: the new
    channels within one bf16 ulp (2^-8) of their max|Pallas| (0.21 and 0.16
    ulps on the CPU: only the order of the float32 sums differs), conv1's 64
    channels passed through bitwise."""
    rng = np.random.default_rng(4)
    x64 = rng.random(X64_SHAPE).astype(np.float32)
    blocks = _blocks(rng)
    blocks = {"thw": blocks[:1], "hw": _blocks(rng, modes=("hw",))}[which]
    want = dense_backbone_fused(jnp.asarray(x64, jnp.bfloat16), _jax_blocks(blocks))
    want = np.asarray(want.astype(jnp.float32))
    got = dense_backbone_ref(_t(x64).bfloat16(), _torch_blocks(blocks))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    got = got.float().numpy()
    np.testing.assert_array_equal(got[..., :64], want[..., :64])
    ulp = 2.0 ** -8 * np.abs(want[..., 64:]).max()
    assert np.abs(got[..., 64:] - want[..., 64:]).max() <= ulp


def test_dense_block_pads_after_activation():
    """`a` is zero at the spatial border and on the temporal pad planes, as
    the reference pads after the activation; padding the buffer's zeros
    through the chain instead gives relu(sb * (relu(oa) @ Wa) + ob) there."""
    rng = np.random.default_rng(5)
    b = _torch_blocks(_blocks(rng, modes=("thw",)))[0]
    x = _t(rng.random((1, 3, 6, 5, 64)))
    buf = torch.cat([x, torch.zeros(1, 3, 6, 5, 32)], -1)
    got = dense_block_ref(buf.clone(), b, 0, 3)[..., 64:]

    def chain(v):
        return torch.relu(torch.relu(v * b.sa + b.oa) @ b.wa * b.sb + b.ob)

    want = conv3x3x3_ref(chain(x), b.wb, True) + b.bb
    _close(got, want)
    # the buffer's zeros through the chain: in T, H and W, then in T alone
    a = chain(torch.nn.functional.pad(x, (0, 0, 1, 1, 1, 1, 1, 1)))
    wrong = torch.nn.functional.conv3d(a.permute(0, 4, 1, 2, 3), b.wb.permute(4, 3, 0, 1, 2))
    wrong = wrong.permute(0, 2, 3, 4, 1) + b.bb
    wrong_t = conv3x3x3_ref(chain(torch.nn.functional.pad(x, (0, 0, 0, 0, 0, 0, 1, 1))),
                            b.wb, False) + b.bb
    for w in (wrong, wrong_t):
        assert w.shape == want.shape
        assert not torch.allclose(w, want, rtol=RTOL, atol=1e-3)
        assert torch.allclose(w[:, 1:-1, 1:-1, 1:-1], want[:, 1:-1, 1:-1, 1:-1], atol=1e-5)


def test_dense_block_ref_reads_only_its_window():
    """With NaN everywhere a block may not read, the new channels are
    finite and nothing else changes; a VALID-T block writes the planes
    [in_lo+1, in_hi-1)."""
    rng = np.random.default_rng(6)
    b = _torch_blocks(_blocks(rng, c0=96, g=16, modes=("hw",)))[0]
    buf = torch.full((2, 7, 5, 6, 128), float("nan"))
    buf[:, 1:6, :, :, :96] = _t(rng.random((2, 5, 5, 6, 96)))
    before = buf.clone()
    dense_block_ref(buf, b, 1, 6)
    assert torch.isfinite(buf[:, 2:5, :, :, 96:112]).all()
    changed = torch.zeros_like(buf, dtype=torch.bool)
    changed[:, 2:5, :, :, 96:112] = True
    same = (buf.view(torch.int32) == before.view(torch.int32))
    assert same[~changed].all()


# ---------------------------------------------------------------- kernel 10's plain version

@pytest.mark.parametrize("pad_t", [True, False])
def test_conv3x3x3_ref_matches_tap_kernel(pad_t):
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((2, 7, 9, 13, 48)) * 0.5).astype(np.float32)
    wk = (rng.standard_normal((3, 3, 3, 48, 16)) * 0.05).astype(np.float32)
    want = conv3x3x3_tap(jnp.asarray(x), jnp.asarray(wk), pad_t)
    before = sum(launches.values())
    got = conv3x3x3(_t(x), _t(wk), pad_t)
    assert sum(launches.values()) == before
    assert got.shape == want.shape == (2, 7 if pad_t else 5, 9, 13, 16)
    _close(got, want)
    _close(conv3x3x3_ref(_t(x), _t(wk), pad_t), want)


@pytest.mark.parametrize("pad_t", [True, False])
def test_conv3x3x3_ref_bf16_matches_tap_kernel(pad_t):
    """In bf16: the port's plain version (products summed in float32, one
    rounding, as kernel 10's tensor-core tile) against the Pallas kernel in
    interpret mode, which rounds each dh group of products to bf16 before
    XLA sums the three: a few bf16 ulps apart, within 1e-2 of max|ref|."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((2, 7, 9, 13, 48)) * 0.5).astype(np.float32)
    wk = (rng.standard_normal((3, 3, 3, 48, 16)) * 0.05).astype(np.float32)
    want = conv3x3x3_tap(jnp.asarray(x, jnp.bfloat16), jnp.asarray(wk, jnp.bfloat16), pad_t)
    want = np.asarray(want.astype(jnp.float32))
    got = conv3x3x3(_t(x).bfloat16(), _t(wk).bfloat16(), pad_t)
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 1e-2 * np.abs(want).max(), err


def test_conv3x3x3_gradients_match_jax():
    """The input and weight gradients through `conv3x3x3` against jax.grad of
    conv3x3x3_tap (whose VJP is XLA's)."""
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((1, 5, 8, 9, 24)) * 0.1).astype(np.float32)
    wk = (rng.standard_normal((3, 3, 3, 24, 16)) * 0.05).astype(np.float32)
    gx, gw = jax.grad(lambda a, k: jnp.sum(conv3x3x3_tap(a, k, True) ** 2), (0, 1))(
        jnp.asarray(x), jnp.asarray(wk))
    xt, wt = _t(x).requires_grad_(), _t(wk).requires_grad_()
    (conv3x3x3(xt, wt, True) ** 2).sum().backward()
    _close(xt.grad, gx, atol=1e-4)
    _close(wt.grad, gw, atol=1e-4)


# ---------------------------------------------------------------- the model

@pytest.mark.parametrize("layers", [16, 52])
def test_duf_matches_flax(layers):
    """The port on every conv3d_impl (on the CPU each is its plain
    version) against flax DUF(conv3d_impl="xla"), also in the backbone's
    output, at LR 8x12."""
    rng = np.random.default_rng(9)
    x = rng.random((1, 7, 8, 12, 3)).astype(np.float32)
    jm = JDUF(num_frames=7, layers=layers, conv3d_impl="xla")
    variables = duf_variables(jm, x, rng)
    want = np.asarray(jm.apply(variables, jnp.asarray(x), is_train=False)["sr"])
    assert 0.05 < np.abs(want).max() < 20            # the stats keep activations O(1)
    before = sum(launches.values())
    for impl in ("auto", "fused", "pallas", "xla"):
        model = _port_duf(variables, layers=layers, conv3d_impl=impl)
        with torch.no_grad():
            got = model(_t(x))
        assert got.shape == (1, 1, 32, 48, 3) and got.dtype == torch.float32
        _close(got, want)
    assert sum(launches.values()) == before
    with torch.no_grad():
        xc = model.G.conv1(_t(x))
        feats = [model.G.features(_t(x), plain=True),
                 dense_backbone_ref(xc, model.G.block_params())]
    assert feats[0].shape == (1, 1, 8, 12, 448 if layers == 52 else 256)
    _close(feats[1], feats[0])


def test_duf_matches_numpy_oracle():
    """16L against duf_oracle (tests/test_golden_models.py), float64 there."""
    rng = np.random.default_rng(10)
    x = rng.random((1, 7, 8, 8, 3))

    def w(*shape, s=0.1):
        return rng.standard_normal(shape) * s

    def bn(f):
        return (w(f), 1 + w(f), w(f), rng.uniform(0.5, 1.5, f))   # beta gamma mean var

    p = {"c1k": w(1, 3, 3, 3, 64, s=0.3), "c1b": w(64)}
    tree = {"conv1": {"W": p["c1k"], "b": p["c1b"]}}
    stats = {}
    f = 64
    for r in range(6):
        p[f"bn{r}a"], p[f"bn{r}b"] = bn(f), bn(f)
        p[f"ak{r}"], p[f"ab{r}"] = w(1, 1, 1, f, f, s=1 / np.sqrt(f)), w(f)
        p[f"bk{r}"], p[f"bb{r}"] = w(3, 3, 3, f, 32, s=1 / np.sqrt(27 * f)), w(32)
        for s_ in "ab":
            beta, gamma, mean, var = p[f"bn{r}{s_}"]
            tree[f"Rbn{r + 1}{s_}"] = {"beta": beta, "gamma": gamma}
            stats[f"Rbn{r + 1}{s_}"] = {"moving_mean": mean, "moving_variance": var,
                                        "biased_mean": mean, "biased_var": var,
                                        "local_step": np.float32(1.0)}
        tree[f"Rconv{r + 1}a"] = {"W": p[f"ak{r}"], "b": p[f"ab{r}"]}
        tree[f"Rconv{r + 1}b"] = {"W": p[f"bk{r}"], "b": p[f"bb{r}"]}
        f += 32
    p["fbn1"] = bn(256)
    tree["fbn1"] = {"beta": p["fbn1"][0], "gamma": p["fbn1"][1]}
    stats["fbn1"] = {"moving_mean": p["fbn1"][2], "moving_variance": p["fbn1"][3],
                     "biased_mean": p["fbn1"][2], "biased_var": p["fbn1"][3],
                     "local_step": np.float32(1.0)}
    for name, key, shape in (("conv2", "c2", (1, 3, 3, 256, 256)), ("rconv1", "r1", (1, 1, 1, 256, 256)),
                             ("rconv2", "r2", (1, 1, 1, 256, 48)), ("fconv1", "f1", (1, 1, 1, 256, 512)),
                             ("fconv2", "f2", (1, 1, 1, 512, 400))):
        p[key + "k"], p[key + "b"] = w(*shape, s=1 / np.sqrt(np.prod(shape[:-1]))), w(shape[-1])
        tree[name] = {"W": p[key + "k"], "b": p[key + "b"]}
    want = duf_oracle(x, p)
    model = _port_duf({"params": {"G": tree}, "batch_stats": {"G": stats}}, layers=16)
    with torch.no_grad():
        got = model(torch.from_numpy(x.astype(np.float32)))[:, 0].numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_seeded_duf_keeps_activations_o1():
    """The chip runs' DUF: the same seed gives the same model, BatchNorm
    offsets and statistics are drawn (the init's moving_variance of 0 would
    make the activations about 1e17), and the features stay O(1)."""
    a, b = (seeded_model("duf", torch.float32, 3, "cpu", layers=16) for _ in range(2))
    for (name, t), u in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(t, u), name
    var = a.G.Rbn2b.moving_variance
    assert (var >= 0.5).all() and (var <= 1.5).all() and (a.G.fbn1.beta != 0).all()
    with torch.no_grad():
        feats = a.G.features(torch.rand((1, 7, 8, 12, 3), generator=torch.Generator().manual_seed(0)))
    assert 0.3 < feats.pow(2).mean().sqrt().item() < 3


# ---------------------------------------------------------------- serving

@pytest.fixture(scope="module")
def odd_dataset(tmp_path_factory):
    """One sequence of 6 frames, HR 44x52, LR 11x13: odd, so the Predictor
    pads to even and crops back."""
    root = tmp_path_factory.mktemp("dufdata")
    _, seq_dirs = make_dataset(str(root), num_seqs=1, num_frames=6, hw=(44, 52))
    return str(root), seq_dirs[0]


def _pngs(directory):
    return sorted(glob.glob(os.path.join(directory, "*.png")))


def test_predictor_matches_jax_predictor(odd_dataset):
    """test_video_lr within 1 LSB of the JAX Predictor, and testvideos reads
    blur4/ by default (the JAX Predictor degrades truth/ for PFNL only)."""
    root, seq = odd_dataset
    x = np.zeros((1, 7, 12, 14, 3), np.float32)
    jm = JDUF(num_frames=7, layers=16)
    variables = duf_variables(jm, x, np.random.default_rng(12))
    JPredictor(preset("duf"), jm, variables).test_video_lr(seq, name="lr_jax")
    tp = Predictor(_port_duf(variables, layers=16))
    tp.test_video_lr(seq, name="lr_torch")
    want, got = _pngs(os.path.join(seq, "lr_jax")), _pngs(os.path.join(seq, "lr_torch"))
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
    assert len(got) == 6
    for a, b in zip(got, want):
        ia, ib = imread(a).astype(int), imread(b).astype(int)
        assert ia.shape == (44, 52, 3)
        assert np.abs(ia - ib).max() <= 1, a
    tp.testvideos(root, name="all_torch")
    for a, b in zip(_pngs(os.path.join(seq, "all_torch")), got):
        np.testing.assert_array_equal(imread(a), imread(b))


def _save_npz(variables, path):
    """Both collections in one flat .npz, keys '/'-joined from the
    collection name down."""
    flat = {}
    for coll, tree in variables.items():
        for keys, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            flat["/".join([coll] + [k.key for k in keys])] = np.asarray(leaf)
    np.savez(path, **flat)


def test_weights_carry_batch_stats(tmp_path):
    """from_flax merges both collections (local_step has shape ()), and
    load_npz reads a checkpoint whose keys carry the collection names."""
    x = np.zeros((1, 7, 4, 4, 3), np.float32)
    variables = duf_variables(JDUF(num_frames=7, layers=16), x, np.random.default_rng(11))
    sd = from_flax(variables["params"], variables["batch_stats"])
    assert sd["G.Rbn1a.local_step"].shape == ()
    assert tuple(sd["G.Rconv4b.W"].shape) == (3, 3, 3, 160, 32)
    _save_npz(variables, tmp_path / "duf.npz")
    loaded = load_npz(str(tmp_path / "duf.npz"))
    assert sorted(loaded) == sorted(sd)
    assert all(torch.equal(loaded[k], sd[k]) for k in sd)
    DUF(layers=16).load_state_dict(loaded)                          # strict


def test_cli_serves_duf(odd_dataset, tmp_path):
    """`test duf --weights`: DUF-52L with a checkpoint's BatchNorm state
    reads blur4/ and writes the frames the Predictor writes."""
    root, seq = odd_dataset
    x = np.zeros((1, 7, 12, 14, 3), np.float32)
    variables = duf_variables(JDUF(num_frames=7, layers=52), x, np.random.default_rng(13))
    _save_npz(variables, tmp_path / "duf52.npz")
    cli(["test", "duf", "--data", root, "--device", "cpu", "--name", "sr_cli",
         "--weights", str(tmp_path / "duf52.npz")])
    Predictor(_port_duf(variables, layers=52)).test_video_lr(seq, name="sr_api")
    outs, api = _pngs(os.path.join(seq, "sr_cli")), _pngs(os.path.join(seq, "sr_api"))
    assert len(outs) == 6 and imread(outs[0]).shape == (44, 52, 3)
    for a, b in zip(outs, api):
        np.testing.assert_array_equal(imread(a), imread(b))
