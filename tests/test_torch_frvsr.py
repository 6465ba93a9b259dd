"""FRVSR and its streaming serving path against the JAX package, on the CPU.

The k=3 transposed conv against lax and flax, the flow net at a size the
pools floor (20x28) and at one they do not, the model's `step` and
`forward` against flax on the same bridged weights (seeded numpy draws,
every bias non-zero; the JAX side runs kernel 7 in interpret mode) and
against the golden first-step oracle, and the Predictor's recurrent path
against the JAX Predictor's `_run_recurrent`.  The JAX forwards are jitted
once per dtype and shared, which keeps the file's interpret-mode compiles
to three."""

import glob
import os

import numpy as np
import flax.linen as fnn
import jax
import jax.numpy as jnp
import pytest
import torch
from jax import lax

torch.set_num_threads(2)

from pfnl_tpu.config import preset
from pfnl_tpu.infer.predictor import Predictor as JPredictor
from pfnl_tpu.models.flows import FRVSRFlow as JFRVSRFlow
from pfnl_tpu.models.frvsr import FRVSR as JFRVSR
from pfnl_tpu.utils.image_io import imread

from pfnl_tpu_torch.infer.predictor import MemoryFrames, Predictor
from pfnl_tpu_torch.models import MODEL_REGISTRY, FRVSR
from pfnl_tpu_torch.models.flows import FRVSRFlow
from pfnl_tpu_torch.ops.conv import conv_transpose_same2
from pfnl_tpu_torch.ops.cuda import launches
from pfnl_tpu_torch.utils.weights import from_flax
from tests.test_golden_models import frvsr_first_step_oracle
from tests.test_torch_flows import random_params
from tests.util_data import make_dataset

MF, NB, T = 16, 2, 3
LR_HW = (20, 28)  # the pools floor 20 -> 10 -> 5 -> 2, the decoder returns 16 rows


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / np.linalg.norm(want)


# ---------------------------------------------------------------- the transposed conv

@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("hw", [(5, 6), (4, 4)])
def test_conv_transpose_same2_matches_lax(k, hw):
    rng = np.random.default_rng(k * 10 + hw[0])
    x = rng.standard_normal((2,) + hw + (4,)).astype(np.float32)
    kern = rng.standard_normal((k, k, 4, 3)).astype(np.float32)
    want = lax.conv_transpose(jnp.asarray(x), jnp.asarray(kern), (2, 2), "SAME",
                              dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = conv_transpose_same2(torch.from_numpy(x), torch.from_numpy(kern))
    assert got.shape == (2, 2 * hw[0], 2 * hw[1], 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("hw", [(5, 6), (4, 4)])
def test_conv_transpose_same2_matches_flax_large1(hw):
    """FRVSR's large1: flax nn.ConvTranspose(k=3, stride 2, "SAME")."""
    rng = np.random.default_rng(hw[1])
    x = rng.standard_normal((1,) + hw + (4,)).astype(np.float32)
    layer = fnn.ConvTranspose(4, (3, 3), strides=(2, 2), padding="SAME")
    params = random_params(layer, (jnp.asarray(x),), rng)
    want = layer.apply({"params": params}, jnp.asarray(x))
    got = conv_transpose_same2(torch.from_numpy(x), torch.from_numpy(params["kernel"]))
    np.testing.assert_allclose((got + torch.from_numpy(params["bias"])).numpy(),
                               np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------- the flow net

@pytest.mark.parametrize("hw", [LR_HW, (16, 24)])
def test_flow_matches_flax(hw):
    rng = np.random.default_rng(hw[0])
    a, b = (rng.random((2,) + hw + (3,)).astype(np.float32) for _ in range(2))
    jm = JFRVSRFlow()
    params = random_params(jm, (jnp.asarray(a), jnp.asarray(b)), rng)
    want = jm.apply({"params": params}, jnp.asarray(a), jnp.asarray(b))
    net = FRVSRFlow()
    net.load_state_dict(from_flax(params))
    with torch.no_grad():
        got = net(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (2,) + hw + (2,)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# ---------------------------------------------------------------- the model

@pytest.fixture(scope="module")
def case():
    """Seeded LR frames [1,T,20,28,3], flax params, and the JAX forward's
    outputs in float32 and bfloat16 (jitted: one compile each)."""
    x = np.random.default_rng(1).random((1, T) + LR_HW + (3,)).astype(np.float32)
    params = random_params(JFRVSR(num_frames=T, mf=MF, num_blocks=NB), (jnp.asarray(x),),
                           np.random.default_rng(2))
    want = {}
    for key, dt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        jm = JFRVSR(num_frames=T, mf=MF, num_blocks=NB, dtype=dt)
        out = jax.jit(jm.apply)({"params": params}, jnp.asarray(x))
        want[key] = {k: np.asarray(v) for k, v in out.items()}
    return x, params, want


def _port(params, dtype=torch.float32):
    model = FRVSR(num_frames=T, mf=MF, num_blocks=NB, dtype=dtype)
    model.load_state_dict(from_flax(params))  # strict: every flax name fits
    return model.eval()


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)],
                         ids=["float32", "bfloat16"])
def test_forward_matches_flax(case, dtype, tol):
    x, params, want = case
    want = want[str(dtype).replace("torch.", "")]
    before = sum(launches.values())
    with torch.no_grad():
        got = _port(params, dtype)(torch.from_numpy(x))
    assert sum(launches.values()) == before  # a CPU tensor launches no kernel
    assert got["sr"].shape == (1, T, 80, 112, 3) and got["warps"].shape == (1, T - 1) + LR_HW + (3,)
    assert got["sr"].dtype == got["warps"].dtype == torch.float32
    for k in ("sr", "warps"):
        assert _rel(got[k], want[k]) <= tol, k


@pytest.mark.parametrize("which", ["first", "later"])
def test_step_matches_flax(case, which):
    """`step` against the JAX recurrence: the first frame alone, and a later
    frame from the JAX model's own previous SR (teacher-forced)."""
    x, params, want = case
    model = _port(params)
    xs = torch.from_numpy(x)
    with torch.no_grad():
        if which == "first":
            got, ref = model.step(xs[:, 0]), want["float32"]["sr"][:, 0]
        else:
            est = torch.tensor(want["float32"]["sr"][:, 1])
            got, ref = model.step(xs[:, 2], xs[:, 1], est), want["float32"]["sr"][:, 2]
    assert got.shape == (1, 80, 112, 3) and got.dtype == torch.float32
    assert _rel(got, ref) <= 1e-4


def test_first_step_matches_golden_oracle():
    """The float64 oracle and tolerances of test_golden_models.py: TF-layout
    transposed kernels mirrored and transposed as the importer does."""
    rng = np.random.default_rng(7)
    nb, mf = 2, 8
    x = rng.random((1, 8, 8, 3))

    def w(*shape):
        return rng.standard_normal(shape) * 0.2

    p = dict(k00=w(3, 3, 3, mf), b00=w(mf), kl1=w(3, 3, mf, mf), bl1=w(mf), kl2=w(3, 3, mf, mf),
             bl2=w(mf), ko=w(3, 3, mf, 3), bo=w(3))
    for j in range(nb):
        p[f"k1_{j}"], p[f"b1_{j}"] = w(3, 3, mf, mf), w(mf)
        p[f"k2_{j}"], p[f"b2_{j}"] = w(3, 3, mf, mf), w(mf)
    want = frvsr_first_step_oracle(x, p, nb, mf)
    model = FRVSR(mf=mf, num_blocks=nb)
    state = model.state_dict()
    state.update({"conv0_0.kernel": p["k00"], "conv0_0.bias": p["b00"], "out.kernel": p["ko"],
                  "out.bias": p["bo"]})
    for name, kk, bb in (("large1", "kl1", "bl1"), ("large2", "kl2", "bl2")):
        state[f"{name}.kernel"] = p[kk][::-1, ::-1].transpose(0, 1, 3, 2)
        state[f"{name}.bias"] = p[bb]
    for j in range(nb):
        for c in (1, 2):
            state[f"conv{c}_{j}.kernel"], state[f"conv{c}_{j}.bias"] = p[f"k{c}_{j}"], p[f"b{c}_{j}"]
    model.load_state_dict({k: torch.as_tensor(np.ascontiguousarray(v), dtype=torch.float32)
                           for k, v in state.items()})
    with torch.no_grad():
        got = model.step(torch.from_numpy(x.astype(np.float32))).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_seeded_recurrence_stays_bounded():
    """The premise of chip_smoke.py phase 8: at full width (mf 128, 10
    blocks) with its seeded weights, the SR fed back frame after frame does
    not grow over the 24-frame clip (here at LR 32x48, float32): no frame's
    rms exceeds the first's, and the last five settle within 5%."""
    from chip_smoke import synthetic_clip
    from pfnl_tpu_torch.infer.profile_serving import seeded_model
    from pfnl_tpu_torch.ops.degrade import downsample_4d

    clip = torch.from_numpy(synthetic_clip(24, 128, 192, 0)).float() / 255.0
    model = seeded_model("frvsr", torch.float32, 0, "cpu")
    rms = []
    with torch.no_grad():
        lr = torch.round(downsample_4d(clip, 4).clamp(0, 1) * 255) / 255
        sr = model.step(lr[0:1])
        rms.append(sr.pow(2).mean().sqrt().item())
        for t in range(1, 24):
            sr = model.step(lr[t:t + 1], lr[t - 1:t], sr)
            rms.append(sr.pow(2).mean().sqrt().item())
    assert max(rms) <= rms[0] and np.isfinite(rms).all()
    assert max(rms[-5:]) <= 1.05 * min(rms[-5:])


def test_registered_with_the_serving_attributes():
    model = MODEL_REGISTRY["frvsr"](num_frames=10, scale=4, dtype=torch.float32,
                                    generator=torch.Generator().manual_seed(0))
    assert (model.recurrent, model.y_channel, model.reads_truth, model.lr_multiple) == (
        True, False, False, 1)
    assert (model.mf, model.num_blocks) == (128, 10)


# ---------------------------------------------------------------- serving

@pytest.fixture(scope="module")
def served(tmp_path_factory, case):
    """One sequence of 9 frames, LR 20x28, served by the JAX Predictor
    (`_run_recurrent`, one chunk of 8 after frame 0) into `jax/`."""
    _, params, _ = case
    root = tmp_path_factory.mktemp("frvsr_data")
    _, seq_dirs = make_dataset(str(root), num_seqs=1, num_frames=9, hw=(80, 112))
    jm = JFRVSR(num_frames=T, mf=MF, num_blocks=NB)
    JPredictor(preset("frvsr"), jm, {"params": params}).test_video_lr(seq_dirs[0], name="jax")
    return str(root), seq_dirs[0], params


def _pngs(directory):
    return [imread(p) for p in sorted(glob.glob(os.path.join(directory, "*.png")))]


def test_predictor_matches_jax_run_recurrent(served):
    _, seq, params = served
    Predictor(_port(params)).test_video_lr(seq, name="torch")
    got, want = _pngs(os.path.join(seq, "torch")), _pngs(os.path.join(seq, "jax"))
    assert len(got) == len(want) == 9 and got[0].shape == (80, 112, 3)
    diff = np.abs(np.stack(got).astype(int) - np.stack(want).astype(int))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.999


@pytest.mark.parametrize("chunk_frames", [1, 7, 64])
def test_predictor_frames_do_not_depend_on_chunk_frames(served, chunk_frames):
    """Chunks of 1, of 7 (a ragged tail of 1) and of 64 (more than the 9
    frames) give the bytes of the default 32."""
    _, seq, params = served
    lrs = np.stack(_pngs(os.path.join(seq, "blur4"))).astype(np.float32) / 255.0
    frames = {}
    for chunk in (32, chunk_frames):
        mem = MemoryFrames()
        Predictor(_port(params), sink=mem)._run_recurrent(lrs, f"out{chunk}", chunk)
        frames[chunk] = [mem.read(p) for p in mem.list(f"out{chunk}")]
    assert len(frames[32]) == len(frames[chunk_frames]) == 9
    assert all(np.array_equal(a, b) for a, b in zip(frames[32], frames[chunk_frames]))


def test_cli_test_frvsr_serves_blur4(served):
    from pfnl_tpu_torch.__main__ import main

    root, seq, _ = served
    main(["test", "frvsr", "--data", root, "--device", "cpu", "--name", "sr_cli"])
    outs = _pngs(os.path.join(seq, "sr_cli"))
    assert len(outs) == 9 and outs[0].shape == (80, 112, 3)
