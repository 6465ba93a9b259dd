"""The port's slice as a whole against the JAX package, on the CPU: PFNL
against flax PFNL and the numpy oracle, the Predictor against the JAX
Predictor, the weight bridge, the CLI, and the port's import hygiene."""

import glob
import os
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from pfnl_tpu.config import preset
from pfnl_tpu.infer.predictor import Predictor as JPredictor
from pfnl_tpu.models.pfnl import PFNL as JPFNL
from pfnl_tpu.utils.image_io import imread

from pfnl_tpu_torch.infer.predictor import MemoryFrames, Predictor
from pfnl_tpu_torch.models.pfnl import PFNL
from pfnl_tpu_torch.ops.cuda import launches
from pfnl_tpu_torch.utils.weights import from_flax, load_npz
from tests.test_golden_models import pfnl_oracle
from tests.util_data import make_dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flax_pfnl(num_frames, num_blocks, x):
    jm = JPFNL(num_frames=num_frames, num_blocks=num_blocks)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    return jm, variables, jax.tree_util.tree_map(np.asarray, variables["params"])


def _port(params, num_frames, num_blocks):
    model = PFNL(num_frames=num_frames, num_blocks=num_blocks)
    model.load_state_dict(from_flax(params))
    return model.eval()


@pytest.mark.parametrize("num_blocks,atol", [
    (2, 2e-5),
    # 20 random residual blocks grow the output to ~90, and the two
    # frameworks' float32 sums, taken in other orders, differ in
    # proportion (2e-4 measured)
    (20, 1e-3),
])
def test_pfnl_matches_flax(num_blocks, atol):
    x = np.random.default_rng(0).random((1, 7, 12, 16, 3)).astype(np.float32)
    jm, variables, params = _flax_pfnl(7, num_blocks, x)
    want = np.asarray(jm.apply(variables, jnp.asarray(x))["sr"])
    before = sum(launches.values())
    with torch.no_grad():
        got = _port(params, 7, num_blocks)(torch.from_numpy(x)).numpy()
    assert got.shape == (1, 1, 48, 64, 3)
    np.testing.assert_allclose(got, want, atol=atol, rtol=1e-4)
    assert sum(launches.values()) == before  # a CPU tensor launches no kernel


def test_pfnl_matches_numpy_oracle():
    """The golden test's config and weights (test_golden_models.py:166)."""
    rng = np.random.default_rng(42)
    t, h, w, mf = 3, 8, 8, 64
    x = rng.random((1, t, h, w, 3))
    cnl = 3 * t * 4

    def wgt(*shape, s=0.1):
        return rng.standard_normal(shape) * s

    p = dict(
        g_k=wgt(1, 1, cnl, cnl), g_b=wgt(cnl), w_k=wgt(1, 1, cnl, cnl), w_b=wgt(cnl),
        k0=wgt(5, 5, 3, mf), b0=wgt(mf), w1=wgt(3, 3, mf, mf), b1=wgt(mf),
        wfuse_cat=wgt(1, 1, t * mf, mf), bfuse=wgt(mf), w2_cat=wgt(3, 3, 2 * mf, mf),
        b2=wgt(mf), km1=wgt(3, 3, t * mf, 48), bm1=wgt(48), km2=wgt(3, 3, 12, 12), bm2=wgt(12),
    )
    want = pfnl_oracle(x, p, t)
    params = {
        "nlblock_0": {"g": {"kernel": p["g_k"], "bias": p["g_b"]},
                      "w": {"kernel": p["w_k"], "bias": p["w_b"]}},
        "conv0": {"kernel": p["k0"], "bias": p["b0"]},
        "conv1_0_kernel": p["w1"], "conv1_0_bias": p["b1"],
        "conv10_0_kernel": np.stack([p["wfuse_cat"][0, 0, mf * i:mf * (i + 1)] for i in range(t)]),
        "conv10_0_bias": p["bfuse"],
        "conv2b_0_kernel": p["w2_cat"][:, :, :mf], "conv2f_0_kernel": p["w2_cat"][:, :, mf:],
        "conv2f_0_bias": p["b2"],
        "convmerge1_kernel": p["km1"], "convmerge1_bias": p["bm1"],
        "convmerge2_kernel": p["km2"], "convmerge2_bias": p["bm2"],
    }
    with torch.no_grad():
        got = _port(params, t, 1)(torch.from_numpy(x.astype(np.float32))).numpy()[:, 0]
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_load_npz_matches_from_flax(tmp_path):
    x = np.zeros((1, 3, 8, 8, 3), np.float32)
    _, _, params = _flax_pfnl(3, 1, x)
    flat = {}

    def walk(node, prefix):
        for k, v in node.items():
            if hasattr(v, "items"):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = v

    walk(params, "")
    path = str(tmp_path / "params.npz")
    np.savez(path, **flat)
    got, want = load_npz(path), from_flax(params)
    assert sorted(got) == sorted(want) and "nlblock_0.g.kernel" in got
    for k in want:
        assert torch.equal(got[k], want[k]), k
    PFNL(num_frames=3, num_blocks=1).load_state_dict(got)  # strict: every name fits


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torchdata")
    _, seq_dirs = make_dataset(str(root), num_seqs=1, num_frames=6, hw=(48, 48))
    return str(root), seq_dirs


def test_predictor_matches_jax_predictor(dataset):
    _, seq_dirs = dataset
    x = np.zeros((1, 3, 12, 12, 3), np.float32)
    jm, variables, params = _flax_pfnl(3, 1, x)
    JPredictor(preset("pfnl", num_frames=3), jm, variables).test_video_truth(
        seq_dirs[0], name="sr_jax")
    Predictor(_port(params, 3, 1)).test_video_truth(seq_dirs[0], name="sr_torch")
    jax_pngs = sorted(glob.glob(os.path.join(seq_dirs[0], "sr_jax", "*.png")))
    torch_pngs = sorted(glob.glob(os.path.join(seq_dirs[0], "sr_torch", "*.png")))
    assert [os.path.basename(p) for p in torch_pngs] == [os.path.basename(p) for p in jax_pngs]
    assert len(torch_pngs) == 6
    for a, b in zip(torch_pngs, jax_pngs):
        ia, ib = imread(a).astype(int), imread(b).astype(int)
        assert ia.shape == (48, 48, 3)
        assert np.abs(ia - ib).max() <= 1, a


def test_predictor_memory_frames_and_odd_size():
    """Frames in memory; odd LR sizes are edge-padded and cropped back."""
    rng = np.random.default_rng(3)
    frames = {f"v/blur4/{i:04d}.png": (rng.random((9, 11, 3)) * 255).astype(np.uint8)
              for i in range(5)}
    mem = MemoryFrames(frames)
    model = PFNL(num_frames=3, num_blocks=1, generator=torch.Generator().manual_seed(0))
    times = Predictor(model, batch_windows=2, source=mem, sink=mem).test_video_lr("v", "sr")
    assert len(times) == 3  # 5 windows in batches of 2
    outs = mem.list("v/sr")
    assert len(outs) == 5
    assert all(mem.read(p).shape == (36, 44, 3) and mem.read(p).dtype == np.uint8 for p in outs)


def test_cli_writes_sr_frames(dataset):
    from pfnl_tpu_torch.__main__ import main

    root, seq_dirs = dataset
    main(["test", "pfnl", "--data", root, "--device", "cpu", "--name", "sr_cli",
          "--compute-dtype", "bfloat16"])
    outs = sorted(glob.glob(os.path.join(seq_dirs[0], "sr_cli", "*.png")))
    assert len(outs) == 6 and imread(outs[0]).shape == (48, 48, 3)


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import pfnl_tpu_torch\n"
        "for m in pkgutil.walk_packages(pfnl_tpu_torch.__path__, 'pfnl_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'pfnl_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=REPO, env=env, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
