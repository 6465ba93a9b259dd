"""The convergence sweep of the port (pfnl_tpu_torch/convergence.py) against
the JAX script it ports (scripts/convergence.py) on the CPU: the synthetic
scenes, the bicubic floor of each evaluator family, the staged-training
and LSTM-clip checks, and the report's tables."""

import importlib.util
import json
import os
import tempfile

import numpy as np
import pytest
import torch

torch.set_num_threads(2)

from pfnl_tpu.config import preset as jpreset
from pfnl_tpu.eval.evaluator import Evaluator as JEvaluator
from pfnl_tpu.train.trainer import _lstm_mask
from pfnl_tpu.utils.image_io import imread

from pfnl_tpu_torch import convergence
from pfnl_tpu_torch.config import preset
from pfnl_tpu_torch.eval.evaluator import Evaluator
from pfnl_tpu_torch.train.trainer import Trainer
from pfnl_tpu_torch.utils.device import tf32_off
from pfnl_tpu_torch.utils.weights import to_flax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    """scripts/<name>.py as a module (the scripts directory is no package)."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}",
                                                  os.path.join(ROOT, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jconv = _script("convergence")


def _frames(seq_dir, sub):
    names = sorted(os.listdir(os.path.join(seq_dir, sub)))
    return np.stack([imread(os.path.join(seq_dir, sub, n)) for n in names])


def _lines(path):
    with open(path) as f:
        return f.read().splitlines()


def test_make_rich_dataset_matches_the_script(tmp_path):
    """truth/ bitwise; blur4/ within one uint8 step at no more than 1e-3 of
    the values (the two degradations' float rounding can fall either side
    of a step); the filelists equal but for the root."""
    ours, theirs = str(tmp_path / "torch"), str(tmp_path / "jax")
    got = convergence.make_rich_dataset(ours, num_seqs=2, num_frames=4)
    want = jconv.make_rich_dataset(theirs, num_seqs=2, num_frames=4)
    for g, w in zip(got, want):
        assert [p.replace(ours, theirs) for p in _lines(g)] == _lines(w)
    for s in ("seq_000", "seq_001"):
        a, b = (os.path.join(r, s) for r in (ours, theirs))
        np.testing.assert_array_equal(_frames(a, "truth"), _frames(b, "truth"))
        lo, lo_j = _frames(a, "blur4").astype(int), _frames(b, "blur4").astype(int)
        assert lo.shape == lo_j.shape == (4, 40, 64, 3)
        diff = np.abs(lo - lo_j)
        assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3


@pytest.fixture(scope="module")
def small_set(tmp_path_factory):
    """make_rich_dataset's two 4-frame 40x48 sequences."""
    root = str(tmp_path_factory.mktemp("small"))
    convergence.make_rich_dataset(root, num_seqs=2, num_frames=4, hw=(40, 48))
    return root


@pytest.mark.parametrize("asked, want", [
    (dict(num_seqs=2, num_frames=4, hw=(40, 48)), True),
    (dict(num_seqs=3, num_frames=4, hw=(40, 48)), False),
    (dict(num_seqs=2, num_frames=20, hw=(40, 48)), False),
    (dict(num_seqs=2, num_frames=4, hw=(160, 256)), False),
])
def test_dataset_matches_only_the_set_rendered(small_set, asked, want):
    """`main` renders the scenes again unless --root holds the full set at
    its size: another count of sequences or frames, or another size, is a
    mismatch."""
    assert convergence.dataset_matches(small_set, **asked) is want


def test_dataset_matches_needs_every_frame(tmp_path):
    """A sequence short of one blur4/ frame, or no filelists, is a mismatch."""
    root = str(tmp_path / "set")
    convergence.make_rich_dataset(root, num_seqs=2, num_frames=4, hw=(40, 48))
    assert convergence.dataset_matches(root, 2, 4, (40, 48))
    os.remove(os.path.join(root, "seq_001", "blur4", "0003.png"))
    assert not convergence.dataset_matches(root, 2, 4, (40, 48))
    assert not convergence.dataset_matches(str(tmp_path / "none"), 2, 4, (40, 48))


def test_tf32_off_restores_the_settings():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        with tf32_off():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@pytest.fixture(scope="module")
def rich_set(tmp_path_factory):
    """Three 20-frame 160x256 sequences: the filelists make_rich_dataset
    writes (one to train on, two to evaluate) and one listing all three."""
    root = str(tmp_path_factory.mktemp("rich"))
    train_list, val_list = convergence.make_rich_dataset(root, num_seqs=3, num_frames=20)
    all_list = os.path.join(root, "filelist_all.txt")
    with open(all_list, "wt") as f:
        f.write("".join(open(p).read() for p in (train_list, val_list)))
    return root, train_list, val_list, all_list


@pytest.mark.parametrize("model", ["pfnl", "vespcn", "frvsr", "duf"])
def test_bicubic_baseline_matches_the_script(rich_set, model):
    """One family of each of the evaluator's four branches, on the same
    frames: within 1e-3 dB."""
    _, _, _, all_list = rich_set
    over = dict(eval_list=all_list, eval_in_size=(32, 56), eval_batch_size=2)
    cfg, jcfg = preset(model, **over), jpreset(model, **over)
    ev, jev = Evaluator(cfg, None), JEvaluator(jcfg, None)
    assert ev.family == jev.family
    got = convergence.bicubic_baseline(ev, cfg)
    want = jconv.bicubic_baseline(jev, jcfg)
    assert np.isfinite(got) and 10 < got < 40
    assert abs(got - want) <= 1e-3


def test_run_family_staged_checks_and_curve(rich_set, tmp_path, monkeypatch):
    """VESPCN for 6 steps, evaluated every 2, its stage switch at 3: the
    flow net frozen through stage 0 and moving in stage 1, a finite curve
    of 3 points in the eval log, the records written; every evaluation
    with TF32 off, the settings restored after."""
    _, train_list, val_list, _ = rich_set
    work = str(tmp_path / "runs")
    flags, run = [], Evaluator.run

    def spy(self, *a, **k):
        flags.append((torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32))
        return run(self, *a, **k)

    monkeypatch.setattr(Evaluator, "run", spy)
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    curve, checks, wall, step = convergence.run_family("vespcn", train_list, val_list, 6, 2,
                                                       work, device="cpu")
    assert flags == [(False, False)] * 3
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == saved
    assert checks == {"flow_frozen_stage0": True, "flow_moves_stage1": True}
    assert [s for s, _ in curve] == [0, 2, 4] and np.all(np.isfinite([p for _, p in curve]))
    assert step == 6 and wall > 0
    baselines = json.load(open(os.path.join(work, "baselines.json")))
    assert set(baselines) == {"vespcn"} and np.isfinite(baselines["vespcn"])
    assert json.load(open(os.path.join(work, "checks.json")))["vespcn"] == dict(checks, steps=6)
    runs = json.load(open(os.path.join(work, "runs.json")))
    assert runs["vespcn"] == dict(wall_s=runs["vespcn"]["wall_s"], device="CPU", steps=6)


def test_drvsr_lstm_clip_selects_the_jax_masks_parameters():
    """The parameters DRVSR's Trainer clips (`lstm_clip_selects_params` is
    `bool(trainer.clipped)`) are those JAX's `_lstm_mask` selects in the
    same tree: as many tensors and elements, no training needed."""
    tr = Trainer(preset("drvsr", reload=False), device="cpu")
    assert tr.clipped
    params, _ = to_flax(tr.model)
    mask = _lstm_mask(params)

    def leaves(tree, m):
        if isinstance(tree, dict):
            return [x for k in tree for x in leaves(tree[k], m[k])]
        return [np.size(tree)] if m else []

    selected = leaves(params, mask)
    assert len(selected) == len(tr.clipped)
    assert sum(selected) == sum(p.numel() for p in tr.clipped)


def _write_logs(work):
    """Eval logs as the two Evaluators write them (PFNL and DUF RGB, a Y
    family's per-frame lists), DUF's step 0 non-finite, a baseline missing
    for FRVSR, checks for the staged families."""
    os.makedirs(work)
    logs = {
        "pfnl": ['{"Iter": 0 , "PSNR": [-30.303451], "MSE": [1071.5]}',
                 '{"Iter": 250 , "PSNR": [17.153001], "MSE": [0.019262]}',
                 '{"Iter": 500 , "PSNR": [18.012345], "MSE": [0.015795]}'],
        "vespcn": ['{"Iter": 0 , "MSE": [0.0081], "PSNR": [20.93112233], "SSIM": [0.61]}',
                   '{"Iter": 250 , "MSE": [0.0061], "PSNR": [23.3301], "SSIM": [0.7]}'],
        "frvsr": ['{"Iter": 0 , "PSNR": [9.1, 9.2, 9.3], "MSE": [0.12, 0.12, 0.11]}',
                  '{"Iter": 250 , "PSNR": [17.5, 17.9, 18.1], "MSE": [0.02, 0.016, 0.015]}'],
        "duf": ['{"Iter": 0 , "PSNR": [NaN], "MSE": [NaN]}',
                '{"Iter": 250 , "PSNR": [-126.8], "MSE": [1e12]}',
                '{"Iter": 500 , "PSNR": [18.97], "MSE": [0.0127]}',
                '{"Iter": 750 , "PSNR": [20.71], "MSE": [0.0085]}'],
    }
    for m, lines in logs.items():
        with open(os.path.join(work, f"{m}.txt"), "wt") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(work, "baselines.json"), "wt") as f:
        json.dump({"pfnl": 17.3312, "vespcn": 21.2711, "duf": 17.3099}, f)
    with open(os.path.join(work, "checks.json"), "wt") as f:
        json.dump({"vespcn": {"flow_frozen_stage0": True, "flow_moves_stage1": True,
                              "steps": 500}, "pfnl": {"steps": 500}}, f)


def test_assemble_writes_the_scripts_tables(tmp_path):
    """The same logs through both: every line from the first family's
    heading on, and the checks lines, equal; the port's header names where
    each family ran."""
    work = str(tmp_path / "runs")
    _write_logs(work)
    ours, theirs = str(tmp_path / "torch.md"), str(tmp_path / "jax.md")
    got = convergence.assemble(work, ours, 750, note="\nnote")
    want = jconv.assemble(work, theirs, 750, note="\nnote")
    np.testing.assert_equal(got, want)  # DUF's NaN at step 0 equal too
    a, b = _lines(ours), _lines(theirs)
    body = lambda lines: lines[lines.index("## pfnl"):]  # noqa: E731
    assert body(a) == body(b)
    assert [x for x in a if "checks:" in x] == [x for x in b if "checks:" in x] != []
    assert "delta: +1.74 dB (step 500 -> 750); vs bicubic +3.40 dB" in a
    assert "pfnl_tpu_torch/convergence.py, on an unrecorded device)." in a
    with open(os.path.join(work, "runs.json"), "wt") as f:
        json.dump({"duf": {"device": "CPU", "wall_s": 2.0, "steps": 750}}, f)
    convergence.assemble(work, ours, 750)
    assert "duf: 750 steps in 2.0 s of training and evals (375.00 steps/s) on CPU" in _lines(ours)


def test_main_keeps_its_records_under_the_temporary_directory(tmp_path, monkeypatch):
    """--workroot (and --root) default to the temporary directory, so
    $TMPDIR: `--assemble-only` reads the logs written there."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    _write_logs(str(tmp_path / "conv_runs_torch"))
    out = str(tmp_path / "CONVERGENCE_TORCH.md")
    convergence.main(["--assemble-only", "--steps", "750", "--out", out, "--device", "cpu"])
    assert [x for x in _lines(out) if x.startswith("## ")] == [
        "## pfnl", "## vespcn", "## frvsr", "## duf"]


def test_frvsr_trainer_steps_follow_the_jax_trainer(rich_set, tmp_path):
    """The family that ends below its floor on the card (FRVSR) through both
    Trainers on the same batches: FRVSR (mf 16, 2 blocks), LR
    crop 16, batch 2, from the JAX Trainer's init (`from_flax`), 3 steps of
    the "frvsr" producer's batches from the scenes (no augmentation, so both
    see the same frames), at 4 frames a window (the recurrence's three
    warps; 10 would only lengthen JAX's compile).  Each step's losses within rtol 1e-4, and each
    parameter's distance from JAX's after the steps within 1e-2 of how far
    JAX's moved it."""
    import jax
    import jax.numpy as jnp

    from pfnl_tpu.models.frvsr import FRVSR as JFRVSR
    from pfnl_tpu.train.trainer import Trainer as JTrainer
    from pfnl_tpu_torch.data.manifest import load_manifest
    from pfnl_tpu_torch.data.pipeline import TrainPipeline
    from pfnl_tpu_torch.models import FRVSR
    from pfnl_tpu_torch.utils.weights import from_flax

    _, train_list, _, _ = rich_set
    over = dict(in_size=16, batch_size=2, num_frames=4, reload=False)
    cfg = preset("frvsr", **over)
    pipe = TrainPipeline(load_manifest(train_list, 4, need_blur=True), "frvsr", 4, 16, 4, 2,
                         seed=0, num_threads=1, prefetch=1)
    try:
        batches = [pipe.get_batch() for _ in range(3)]
    finally:
        pipe.close()
    jtr = JTrainer(jpreset("frvsr", **over), workdir=str(tmp_path / "j"),
                   model=JFRVSR(num_frames=4, mf=16, num_blocks=2))
    state = jtr.init_state(jax.random.PRNGKey(0), batches[0]["lr"].astype(np.float32) / 255)
    as_np = lambda tree: jax.tree_util.tree_map(np.asarray, tree)  # noqa: E731
    start = from_flax(as_np(state.params))
    model = FRVSR(num_frames=4, mf=16, num_blocks=2)
    model.load_state_dict(start)
    tr = Trainer(cfg, workdir=str(tmp_path / "t"), model=model, device="cpu")
    step_fn = jtr.step_fn(0)
    for step, batch in enumerate(batches):
        state, jl = step_fn(state, {k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.PRNGKey(step))
        got = tr.step(batch, tr.step_generator(step))
        for k in ("loss", "loss_sr", "flow_loss"):
            np.testing.assert_allclose(got[k].item(), float(jl[k]), rtol=1e-4, err_msg=k)
    want = from_flax(as_np(state.params))
    for k, p in tr.model.named_parameters():
        moved = (want[k] - start[k]).norm().item()
        assert moved > 0 and (p.detach() - want[k]).norm().item() <= 1e-2 * moved, k
