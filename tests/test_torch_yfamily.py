"""The Y-channel flow families (VESPCN, MCResNet, LTDVSR, DRVSR) and their
serving path against the JAX package, on the CPU.

Each model is held to flax on the same bridged weights (seeded numpy
draws, every bias, PReLU slope and ConvLSTM gate bias non-zero; the JAX
splats run the Pallas kernels in interpret mode) and to the numpy oracle
of tests/test_golden_models.py, in float32.  The Predictor's PNGs are held
to the JAX Predictor's within 1 LSB at an LR size that is not a multiple
of 4, so the pad and the crop run.  A CPU tensor launches no kernel."""

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
from pfnl_tpu.infer.predictor import make_serving_fn
from pfnl_tpu.models.drvsr import DRVSR as JDRVSR
from pfnl_tpu.models.ltdvsr import LTDVSR as JLTDVSR
from pfnl_tpu.models.mcresnet import MCResNet as JMCResNet
from pfnl_tpu.models.vespcn import VESPCN as JVESPCN
from pfnl_tpu.utils.image_io import imread

from pfnl_tpu_torch.infer.predictor import Predictor, serve_rgb
from pfnl_tpu_torch.infer.profile_serving import seeded_model
from pfnl_tpu_torch.models import DRVSR, LTDVSR, MCResNet, VESPCN
from pfnl_tpu_torch.ops.cuda import launches
from pfnl_tpu_torch.utils.weights import from_flax
from tests.test_golden_models import drvsr_oracle, ltdvsr_oracle, mcresnet_oracle, vespcn_oracle
from tests.test_torch_flows import random_params
from tests.util_data import make_dataset

FAMILIES = {"vespcn": (VESPCN, JVESPCN, 3), "mcresnet": (MCResNet, JMCResNet, 5),
            "ltdvsr": (LTDVSR, JLTDVSR, 5), "drvsr": (DRVSR, JDRVSR, 3)}


def _port(family, params, **kw):
    model = FAMILIES[family][0](num_frames=FAMILIES[family][2], **kw)
    model.load_state_dict(from_flax(params))  # strict: every flax name fits
    return model.eval()


def _flax(family, x, seed):
    _, jcls, t = FAMILIES[family]
    jm = jcls(num_frames=t)
    return jm, random_params(jm, (jnp.asarray(x),), np.random.default_rng(seed))


# float32, both sides: the flows agree within 1e-6, and the trunks sum up
# to a few thousand products per output in other orders
SR_ATOL = 2e-5


@pytest.mark.parametrize("family", ["vespcn", "mcresnet", "ltdvsr"])
def test_model_matches_flax(family):
    t = FAMILIES[family][2]
    x = np.random.default_rng(1).random((2, t, 8, 12, 3)).astype(np.float32)
    jm, params = _flax(family, x, 2)
    want = jm.apply({"params": params}, jnp.asarray(x))
    before = sum(launches.values())
    with torch.no_grad():
        got = _port(family, params)(torch.from_numpy(x))
    assert sum(launches.values()) == before  # a CPU tensor launches no kernel
    assert sorted(got) == sorted(want) and got["sr"].shape == (2, 1, 32, 48, 1)
    np.testing.assert_allclose(got["uv"].numpy(), np.asarray(want["uv"]), atol=1e-5)
    np.testing.assert_allclose(got["sr"].numpy(), np.asarray(want["sr"]), atol=SR_ATOL)
    for k in ("frames_y", "ref_y"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), atol=1e-6)


def test_drvsr_matches_flax_full_and_last_only():
    """Both forms against flax; last_only gives the full form's last frame
    and computes no warped_lr."""
    x = np.random.default_rng(3).random((2, 3, 8, 12, 3)).astype(np.float32)
    jm, params = _flax("drvsr", x, 4)
    model = _port("drvsr", params)
    before = sum(launches.values())
    with torch.no_grad():
        full = model(torch.from_numpy(x))
        last = model(torch.from_numpy(x), last_only=True)
    assert sum(launches.values()) == before
    want = jm.apply({"params": params}, jnp.asarray(x))
    want_last = jm.apply({"params": params}, jnp.asarray(x), last_only=True)
    assert full["sr"].shape == (2, 3, 32, 48, 1) and last["sr"].shape == (2, 1, 32, 48, 1)
    assert "warped_lr" not in last
    np.testing.assert_allclose(full["sr"].numpy(), np.asarray(want["sr"]), atol=SR_ATOL)
    np.testing.assert_allclose(full["warped_lr"].numpy(), np.asarray(want["warped_lr"]),
                               atol=1e-5)
    np.testing.assert_allclose(last["sr"].numpy(), np.asarray(want_last["sr"]), atol=SR_ATOL)
    np.testing.assert_allclose(last["sr"].numpy(), full["sr"][:, -1:].numpy(), atol=1e-6)


# ---------------------------------------------------------------- numpy oracles

def _w(rng, *shape, s=0.1):
    return rng.standard_normal(shape) * s


def _easyflow_p(rng):
    p = {}
    for name, shape in (("c1", (5, 5, 2, 24)), ("c2", (3, 3, 24, 24)), ("c3", (5, 5, 24, 24)),
                        ("c4", (3, 3, 24, 24)), ("c5", (3, 3, 24, 32)), ("s1", (5, 5, 5, 24)),
                        ("s2", (3, 3, 24, 24)), ("s3", (3, 3, 24, 24)), ("s4", (3, 3, 24, 24)),
                        ("s5", (3, 3, 24, 8))):
        p[name + "k"], p[name + "b"] = _w(rng, *shape), _w(rng, shape[-1])
    return p


def _easyflow_tree(p):
    return {n: {"kernel": p[n + "k"], "bias": p[n + "b"]}
            for n in ("c1", "c2", "c3", "c4", "c5", "s1", "s2", "s3", "s4", "s5")}


def _kb(p, k):
    return {"kernel": p[k + "k"], "bias": p[k + "b"]}


def _oracle_case(family, rng, t):
    """(p for the oracle, the same weights as a flax params tree)."""
    if family == "vespcn":
        p = _easyflow_p(rng)
        p.update(e1k=_w(rng, 5, 5, t, 24), e1b=_w(rng, 24), c6k=_w(rng, 3, 3, 24, 16),
                 c6b=_w(rng, 16), rok=_w(rng, 3, 3, 4, 4), rob=_w(rng, 4),
                 alphas=[_w(rng, 24, s=0.3) for _ in range(10)] + [_w(rng, 16, s=0.3)])
        for i in range(9):
            p[f"e2k{i}"], p[f"e2b{i}"] = _w(rng, 3, 3, 24, 24), _w(rng, 24)
        tree = {"easyflow": _easyflow_tree(p), "enc1": _kb(p, "e1"), "conv6": _kb(p, "c6"),
                "rnn_out": _kb(p, "ro")}
        tree.update({f"enc2_{i}": {"kernel": p[f"e2k{i}"], "bias": p[f"e2b{i}"]}
                     for i in range(9)})
        tree.update({f"prelu_{i}": {"alpha": a} for i, a in enumerate(p["alphas"])})
    elif family == "mcresnet":
        p = _easyflow_p(rng)
        p.update(c6k=_w(rng, 3, 3, 32, 16), c6b=_w(rng, 16), c6a=_w(rng, 16, s=0.3),
                 rok=_w(rng, 3, 3, 4, 4), rob=_w(rng, 4),
                 ea=[_w(rng, 64, s=0.3) for _ in range(t)],
                 ra=[_w(rng, 32, s=0.3) for _ in range(9)])
        for d in range(t // 2 + 1):
            p[f"d{d}k"], p[f"d{d}b"] = _w(rng, 5, 5, 1, 64), _w(rng, 64)
        for i in range(9):
            p[f"r{i}k"], p[f"r{i}b"] = _w(rng, 3, 3, 64 * t if i == 0 else 32, 32), _w(rng, 32)
        tree = {"easyflow": _easyflow_tree(p), "conv6": _kb(p, "c6"),
                "conv6_prelu": {"alpha": p["c6a"]}, "rnn_out": _kb(p, "ro")}
        tree.update({f"enc1_{d}": _kb(p, f"d{d}") for d in range(t // 2 + 1)})
        tree.update({f"enc1_prelu_{i}": {"alpha": p["ea"][i]} for i in range(t)})
        tree.update({f"enc2_{i}": _kb(p, f"r{i}") for i in range(9)})
        tree.update({f"enc2_prelu_{i}": {"alpha": p["ra"][i]} for i in range(9)})
    elif family == "ltdvsr":
        p = dict(fk0=_w(rng, 9, 9, 2, 32), fb0=_w(rng, 32), fk1=_w(rng, 9, 9, 32, 32),
                 fb1=_w(rng, 32), fk2=_w(rng, 3, 3, 32, 2), fb2=_w(rng, 2),
                 tk0=_w(rng, 5, 5, t, 32), tb0=_w(rng, 32), tk1=_w(rng, 5, 5, 32, 16),
                 tb1=_w(rng, 16), tk2=_w(rng, 5, 5, 16, 3), tb2=_w(rng, 3))
        for b, cin in ((0, 1), (1, 3), (2, 5)):
            for i, (k, ci, co) in zip((0, 1, 3, 2), ((5, cin, 64), (3, 64, 64), (3, 64, 64),
                                                    (3, 64, 16))):
                p[f"b{b}k{i}"], p[f"b{b}b{i}"] = _w(rng, k, k, ci, co), _w(rng, co)
        tree = {"flow": {f"conv{i}": {"kernel": p[f"fk{i}"], "bias": p[f"fb{i}"]}
                         for i in range(3)}}
        tree.update({f"conv{b}_{i}": {"kernel": p[f"b{b}k{i}"], "bias": p[f"b{b}b{i}"]}
                     for b in range(3) for i in range(4)})
        tree.update({f"tem{i}": {"kernel": p[f"tk{i}"], "bias": p[f"tb{i}"]} for i in range(3)})
    else:
        p = _easyflow_p(rng)
        p.update(e1k=_w(rng, 5, 5, 1, 32), e1b=_w(rng, 32), e2k=_w(rng, 3, 3, 32, 64),
                 e2b=_w(rng, 64), e21k=_w(rng, 3, 3, 64, 64), e21b=_w(rng, 64),
                 e3k=_w(rng, 3, 3, 64, 128), e3b=_w(rng, 128),
                 gk=_w(rng, 3, 3, 256, 512, s=0.05), gb=_w(rng, 512),
                 e31k=_w(rng, 3, 3, 128, 128), e31b=_w(rng, 128),
                 d1k=_w(rng, 4, 4, 64, 128), d1b=_w(rng, 64),    # TF layout [kh,kw,OUT,IN]
                 d11k=_w(rng, 3, 3, 64, 64), d11b=_w(rng, 64),
                 d2k=_w(rng, 4, 4, 32, 64), d2b=_w(rng, 32),
                 d21k=_w(rng, 3, 3, 32, 32), d21b=_w(rng, 32),
                 d3k=_w(rng, 5, 5, 32, 1), d3b=_w(rng, 1))
        sm = {fl: _kb(p, kk) for fl, kk in (("enc1", "e1"), ("enc2", "e2"), ("enc2_1", "e21"),
                                           ("enc3", "e3"), ("enc3_1", "e31"),
                                           ("dec1_1", "d11"), ("dec2_1", "d21"),
                                           ("dec3", "d3"))}
        sm["lstm"] = {"gates": {"kernel": p["gk"], "bias": p["gb"]}}
        # TF conv2d_transpose -> flax: mirror + in/out transpose (test_golden_models.py)
        for fl, kk in (("dec1", "d1"), ("dec2", "d2")):
            sm[fl] = {"kernel": p[kk + "k"][::-1, ::-1].transpose(0, 1, 3, 2),
                      "bias": p[kk + "b"]}
        tree = {"easyflow": _easyflow_tree(p), "srmodel": sm}
    return p, tree


ORACLES = {"vespcn": (vespcn_oracle, 2e-4, 1e-4), "mcresnet": (mcresnet_oracle, 2e-4, 1e-4),
           "ltdvsr": (ltdvsr_oracle, 2e-4, 1e-4), "drvsr": (drvsr_oracle, 5e-4, 1e-3)}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_model_matches_numpy_oracle(family):
    """The golden tests' float64 oracles and tolerances (test_golden_models.py)."""
    t = FAMILIES[family][2]
    rng = np.random.default_rng(40)
    x = rng.random((1, t, 8, 8, 3))
    p, tree = _oracle_case(family, rng, t)
    oracle, atol, rtol = ORACLES[family]
    want = oracle(x, p)
    with torch.no_grad():
        got = _port(family, tree)(torch.from_numpy(x.astype(np.float32)))["sr"].numpy()
    if family != "drvsr":
        got = got[:, 0]
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


# ---------------------------------------------------------------- serving

@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_serve_rgb_matches_jax_serving_fn(family):
    """The whole serving program, with the model's serve_kwargs (DRVSR:
    last_only), against the JAX package's make_serving_fn."""
    t = FAMILIES[family][2]
    x = np.random.default_rng(6).random((2, t, 8, 12, 3)).astype(np.float32)
    jm, params = _flax(family, x, 7)
    fn, _ = make_serving_fn(family, jm, t)
    want = np.asarray(fn({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = serve_rgb(_port(family, params), torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 32, 48, 3)
    np.testing.assert_allclose(got, want, atol=SR_ATOL)


def test_seeded_model_is_reproducible_with_nonzero_biases():
    """The chip runs' random weights: the same seed gives the same model,
    and no bias or PReLU slope is left at flax's zero."""
    a = seeded_model("vespcn", torch.float32, 3, "cpu")
    b = seeded_model("vespcn", torch.float32, 3, "cpu")
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        if name.endswith(("bias", "alpha")):
            assert (p != 0).all(), name


@pytest.fixture(scope="module")
def odd_dataset(tmp_path_factory):
    """One sequence of 6 frames, HR 44x52, LR 11x13: not multiples of 4."""
    root = tmp_path_factory.mktemp("ydata")
    _, seq_dirs = make_dataset(str(root), num_seqs=1, num_frames=6, hw=(44, 52))
    return str(root), seq_dirs[0]


def _pngs(directory):
    return sorted(glob.glob(os.path.join(directory, "*.png")))


def test_predictor_matches_jax_predictor(odd_dataset):
    _, seq = odd_dataset
    x = np.zeros((1, 3, 12, 16, 3), np.float32)
    jm, params = _flax("vespcn", x, 5)
    jp = JPredictor(preset("vespcn"), jm, {"params": params})
    tp = Predictor(_port("vespcn", params))
    for run in ("test_video_lr", "test_video_truth"):
        getattr(jp, run)(seq, name=f"{run}_jax")
        getattr(tp, run)(seq, name=f"{run}_torch")
        want, got = _pngs(os.path.join(seq, f"{run}_jax")), _pngs(os.path.join(seq, f"{run}_torch"))
        assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want]
        assert len(got) == 6
        for a, b in zip(got, want):
            ia, ib = imread(a).astype(int), imread(b).astype(int)
            assert ia.shape == (44, 52, 3)
            assert np.abs(ia - ib).max() <= 1, a


def test_cli_serves_a_y_family(odd_dataset):
    """`test vespcn` reads blur4/ by default and writes RGB frames at x4."""
    from pfnl_tpu_torch.__main__ import main

    root, seq = odd_dataset
    main(["test", "vespcn", "--data", root, "--device", "cpu", "--name", "sr_cli"])
    outs = _pngs(os.path.join(seq, "sr_cli"))
    assert len(outs) == 6 and imread(outs[0]).shape == (44, 52, 3)
