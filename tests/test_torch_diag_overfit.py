"""The overfit diagnostic of the port (pfnl_tpu_torch/diag_overfit.py)
against the JAX script it ports (scripts/diag_overfit.py) on the CPU, at a
small size: four 20-frame 160x256 scenes (two to train on, two to
evaluate), a few steps of VESPCN at its preset with evaluations every 2."""

import importlib.util
import json
import os
import sys
import tempfile

import numpy as np
import jax
import pytest
import torch

torch.set_num_threads(2)

from pfnl_tpu.train.trainer import Trainer as JTrainer

from pfnl_tpu_torch import convergence, diag_overfit
from pfnl_tpu_torch.models import MODEL_REGISTRY
from pfnl_tpu_torch.train import trainer as trainer_mod
from pfnl_tpu_torch.train.trainer import Trainer
from pfnl_tpu_torch.utils.weights import from_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KEYS = {"curves", "loss", "wall", "zero_flow", "note"}


def _jax_script():
    """scripts/diag_overfit.py as a module (it imports scripts/convergence.py
    as a top-level module)."""
    scripts = os.path.join(ROOT, "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    spec = importlib.util.spec_from_file_location("jax_diag_overfit",
                                                  os.path.join(scripts, "diag_overfit.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """(root, train list, val list, training-subset list) as main writes
    them: the first three training sequences (here both)."""
    root = str(tmp_path_factory.mktemp("diag"))
    train_list, val_list = convergence.make_rich_dataset(os.path.join(root, "ds"), num_seqs=4,
                                                         num_frames=20)
    sub = os.path.join(root, "filelist_train_eval.txt")
    with open(train_list) as f, open(sub, "wt") as g:
        g.write("\n".join(f.read().split()[:3]) + "\n")
    return root, train_list, val_list, sub


def _run(scenes, tmp_path, steps, zero_flow=False, model="vespcn"):
    _, train_list, val_list, sub = scenes
    return diag_overfit.run_variant(f"{model}_{zero_flow}", model, train_list, val_list, sub,
                                    steps, 2, str(tmp_path), zero_flow=zero_flow, device="cpu")


@pytest.fixture
def fitted(monkeypatch):
    """The Trainers that fit ran, and fit's log line every 2 steps."""
    seen, fit = [], Trainer.fit

    def spy(self, *a, **k):
        seen.append(self)
        return fit(self, *a, log_every=2, **k)

    monkeypatch.setattr(Trainer, "fit", spy)
    return seen


@pytest.mark.parametrize("zero_flow", [False, True])
def test_run_variant_returns_the_scripts_record(scenes, tmp_path, fitted, zero_flow):
    """The script's keys; evaluations on both lists at 0, 2 and 4 of 6
    steps, finite; the losses of fit's `Step:N, loss:L` lines; the stage
    switch at steps/2 for the baseline, never for zero-flow."""
    r = _run(scenes, tmp_path, 6, zero_flow)
    assert set(r) == KEYS and r["zero_flow"] is zero_flow and r["note"] == "" and r["wall"] > 0
    for name in ("val", "train"):
        assert [s for s, _ in r["curves"][name]] == [0, 2, 4]
        assert np.all(np.isfinite([p for _, p in r["curves"][name]]))
    assert [s for s, _ in r["loss"]] == [2, 4] and np.all(np.isfinite([v for _, v in r["loss"]]))
    (tr,) = fitted
    assert tr.cfg.stage_switch_step == (10 ** 9 if zero_flow else 3)
    assert (tr.cfg.decay_step, tr.cfg.max_step) == (6.0, 7)
    assert (tr.cfg.eval_in_size, tr.cfg.eval_batch_size) == ((32, 56), 2)


def test_zero_flow_keeps_the_flow_exactly_zero(scenes, tmp_path, fitted):
    """After the run EasyFlow's c5 and s5 are exactly zero (kernel and
    bias), and VESPCN's flow output is zero on a clip."""
    _run(scenes, tmp_path, 4, zero_flow=True)
    model = fitted[0].model
    for lay in ("c5", "s5"):
        for leaf in ("kernel", "bias"):
            assert not model.get_parameter(f"easyflow.{lay}.{leaf}").any()
    x = torch.rand((2, 3, 16, 16, 3), generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        assert not model(x)["uv"].any()
    assert model.get_parameter("easyflow.c4.kernel").any()


@pytest.mark.parametrize("model", ["pfnl", "ltdvsr", "frvsr", "duf"])
def test_zero_flow_needs_an_easyflow_family(scenes, tmp_path, model):
    with pytest.raises(ValueError, match=model):
        _run(scenes, tmp_path, 2, zero_flow=True, model=model)


@pytest.mark.parametrize("zero_flow", [False, True])
def test_step_zero_evaluations_match_the_jax_script(scenes, tmp_path, monkeypatch, zero_flow):
    """From JAX's own flax init (the script's Trainer.init_state, carried by
    utils/weights.from_flax into the port's Trainer): the step-0 evaluations
    on both lists within 1e-3 dB of the JAX script's run_variant."""
    _, train_list, val_list, sub = scenes
    inits, init_state = [], JTrainer.init_state

    def capture(self, *a, **k):
        state = init_state(self, *a, **k)
        inits.append(jax.tree.map(np.array, state.params))  # fit donates the state
        return state

    monkeypatch.setattr(JTrainer, "init_state", capture)
    want = _jax_script().run_variant("jax", "vespcn", train_list, val_list, sub, 2, 2,
                                     str(tmp_path / "jax"), zero_flow=zero_flow)
    assert len(inits) == 1
    build = trainer_mod.build_model

    def from_jax(cfg):
        model = build(cfg)
        model.load_state_dict(from_flax(inits[0]))
        return model

    monkeypatch.setattr(trainer_mod, "build_model", from_jax)
    got = diag_overfit.run_variant("torch", "vespcn", train_list, val_list, sub, 2, 2,
                                   str(tmp_path / "torch"), zero_flow=zero_flow, device="cpu")
    assert set(got) == set(want) == KEYS
    for name in ("val", "train"):
        (s, p), (sj, pj) = got["curves"][name][0], want["curves"][name][0]
        assert s == sj == 0 and abs(p - pj) <= 1e-3, (name, p, pj)


def test_main_writes_its_json_under_the_temporary_directory(scenes, tmp_path, monkeypatch):
    """--workroot and --out by default under tempfile.gettempdir(): both
    variants in the JSON, the training-subset list the first training
    sequences."""
    root, train_list, _, _ = scenes
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    results = diag_overfit.main(["--steps", "2", "--eval-every", "2", "--root",
                                 os.path.join(root, "ds"), "--device", "cpu"])
    with open(tmp_path / "diag_overfit_torch.json") as f:
        saved = json.load(f)
    assert sorted(saved) == sorted(results) == ["baseline", "zeroflow"]
    assert all(set(v) == KEYS for v in saved.values())
    with open(tmp_path / "diag_runs_torch" / "filelist_train_eval.txt") as f, \
            open(train_list) as g:
        assert f.read().split() == g.read().split()[:3]


@pytest.mark.skipif(torch.cuda.is_available(), reason="a machine with a GPU trains on it")
def test_main_has_no_cpu_fallback(scenes, tmp_path):
    root = scenes[0]
    with pytest.raises((AssertionError, RuntimeError)):
        diag_overfit.main(["--steps", "2", "--root", os.path.join(root, "ds"), "--workroot",
                           str(tmp_path / "w"), "--out", str(tmp_path / "o.json")])
