"""The Evaluator's VESPCN, FRVSR and DUF branches against the JAX package's
Evaluator on the same weights, on the CPU (kernels 7 and 8 in interpret
mode on the JAX side): PSNR, SSIM and the log line; `compute_ssim_batch`
against the float64 `compute_ssim` and JAX's; `eval` on the command line
from a model-only checkpoint, as `import-tf1` writes it."""

import os
import re

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from pfnl_tpu.config import preset as j_preset
from pfnl_tpu.eval.evaluator import Evaluator as JEvaluator
from pfnl_tpu.eval.metrics import compute_ssim_batch as j_compute_ssim_batch
from pfnl_tpu.models.drvsr import DRVSR as JDRVSR
from pfnl_tpu.models.duf import DUF as JDUF
from pfnl_tpu.models.frvsr import FRVSR as JFRVSR
from pfnl_tpu.models.vespcn import VESPCN as JVESPCN

from pfnl_tpu_torch.__main__ import main
from pfnl_tpu_torch.config import preset
from pfnl_tpu_torch.eval.evaluator import Evaluator
from pfnl_tpu_torch.eval.metrics import compute_ssim, compute_ssim_batch
from pfnl_tpu_torch.infer.profile_serving import seeded_model
from pfnl_tpu_torch.models import DRVSR, DUF, FRVSR, VESPCN
from pfnl_tpu_torch.train.trainer import save_checkpoint
from pfnl_tpu_torch.utils.weights import from_flax
from tests.test_torch_duf import duf_variables
from tests.test_torch_flows import random_params
from tests.util_data import make_dataset

# family -> (port class, flax class, constructor arguments beyond the preset's num_frames)
FAMILIES = {"vespcn": (VESPCN, JVESPCN, {}), "drvsr": (DRVSR, JDRVSR, {}),
            "frvsr": (FRVSR, JFRVSR, {"mf": 8, "num_blocks": 1}),
            "duf": (DUF, JDUF, {"layers": 16})}
EVAL = dict(eval_in_size=(8, 8), eval_batch_size=2, reload=False)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """4 sequences of 20 frames (centre 15 exists): 4 windows, 2 batches."""
    filelist, _ = make_dataset(str(tmp_path_factory.mktemp("evalfam")), num_seqs=4,
                               num_frames=20, hw=(48, 48))
    return filelist


def _models(family, t):
    cls, jcls, kw = FAMILIES[family]
    x = jnp.zeros((1, t, 8, 8, 3), jnp.float32)
    rng = np.random.default_rng(50)
    if family == "duf":
        jm = jcls(num_frames=t, conv3d_impl="xla", **kw)
        variables = duf_variables(jm, x, rng)
        state = from_flax(variables["params"], variables["batch_stats"])
    else:
        jm = jcls(num_frames=t, **kw)
        variables = {"params": random_params(jm, (x,), rng)}
        state = from_flax(jax.tree_util.tree_map(np.asarray, variables["params"]))
    model = cls(num_frames=t, **kw)
    model.load_state_dict(state)  # strict: every flax name fits
    return jm, variables, model


def _log(path):
    with open(path) as f:
        (line,) = f.read().splitlines()
    return line


def _fields(line):
    """The log line's keys in order, and its lists of numbers as strings."""
    return re.findall(r'"(\w+)":', line), re.findall(r"\[([^\]]*)\]", line)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_evaluator_matches_jax(family, dataset, tmp_path):
    """PSNR within 1e-3 dB, SSIM within 1e-4; the same log line: keys and
    their order, T columns (DRVSR's full forward: 3, FRVSR: 10), the
    truncation (1e-8 with SSIM, 1e-6 without)."""
    cfg = preset(family, eval_list=dataset, **EVAL)
    jcfg = j_preset(family, eval_list=dataset, **EVAL)
    jm, variables, model = _models(family, cfg.num_frames)
    jlog, tlog = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    want = JEvaluator(jcfg, jm).run(variables, 9, log_path=jlog, print_fn=lambda *a: None)
    printed = []
    model.train()  # the Evaluator runs the model in eval mode and gives it back as it was
    got = Evaluator(cfg, model).run(9, log_path=tlog, print_fn=printed.append)
    assert model.training
    assert len(got) == len(want) == (3 if family in ("vespcn", "drvsr") else 2)
    cols = {"drvsr": 3, "frvsr": 10}.get(family, 1)
    assert got[0].shape == got[1].shape == (cols,)
    np.testing.assert_allclose(got[0], want[0], atol=1e-3)
    if len(got) == 3:
        assert got[2].shape == (cols,)
        np.testing.assert_allclose(got[2], want[2], atol=1e-4)
    assert any(p.startswith("Eval PSNR: [") for p in printed)
    (jkeys, jnums), (keys, nums) = _fields(_log(jlog)), _fields(_log(tlog))
    assert keys == jkeys and keys[0] == "Iter" and _log(tlog).startswith('{"Iter": 9 , "')
    digits = 8 if "SSIM" in keys else 6
    for mine, theirs in zip(nums, jnums):
        vals = mine.split(", ")
        assert len(vals) == len(theirs.split(", ")) == cols
        assert all(len(v.split(".")[-1]) <= digits for v in vals)


@pytest.mark.parametrize("shape", [(2, 3, 20, 24), (1, 5, 11)])
def test_compute_ssim_batch_matches_float64_and_jax(shape):
    rng = np.random.default_rng(51)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    got = compute_ssim_batch(torch.from_numpy(a), torch.from_numpy(b), l=1.0)
    assert got.shape == shape[:-2] and got.dtype == torch.float32
    flat_a, flat_b = a.reshape((-1,) + shape[-2:]), b.reshape((-1,) + shape[-2:])
    want = np.array([compute_ssim(x, y, l=1.0) for x, y in zip(flat_a, flat_b)])
    np.testing.assert_allclose(got.numpy().reshape(-1), want, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(j_compute_ssim_batch(a, b, l=1.0)),
                               atol=1e-5)


@pytest.mark.parametrize("family", ["vespcn", "duf"])
def test_cli_eval_from_a_model_only_checkpoint(family, dataset, tmp_path):
    """What import-tf1 writes (step 0, the model alone) evaluates at its
    step, as the Evaluator does on the same weights."""
    cfg = preset(family, eval_list=dataset, **EVAL)
    if family == "duf":  # seeded BatchNorm statistics keep the activations O(1)
        model = seeded_model("duf", torch.float32, 3, device="cpu")
    else:
        model = VESPCN(num_frames=cfg.num_frames, generator=torch.Generator().manual_seed(3))
    save_dir = str(tmp_path / "ck")
    save_checkpoint(save_dir, {"step": 0, "model": model.state_dict()})
    main(["eval", family, "--save-dir", save_dir, "--eval-list", dataset, "--eval-in-size",
          "8x8", "--device", "cpu"])
    line = _log(os.path.join(save_dir, f"{family}.txt"))
    first = '{"Iter": 0 , "MSE": [' if family == "vespcn" else '{"Iter": 0 , "PSNR": ['
    assert line.startswith(first)
    cfg.eval_batch_size = 4
    want = Evaluator(cfg, model).run(0, print_fn=lambda *a: None)[0]
    psnr = float(re.search(r'"PSNR": \[([^\]]*)\]', line).group(1))
    assert np.isfinite(psnr) and abs(psnr - float(want[0])) < 1e-5
