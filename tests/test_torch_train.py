"""PFNL training in the port against the JAX package, on the CPU: the
whole model's loss and gradients against jax.grad of flax PFNL +
pfnl_loss, the Adam step with the polynomial schedule against optax, the
Trainer's loop and checkpoints, the Evaluator's PSNR, the train CLI, and
the repairs of the port's kernel wrappers and CLI."""

import dataclasses
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

torch.set_num_threads(2)

from pfnl_tpu.config import preset as j_preset
from pfnl_tpu.eval.evaluator import Evaluator as JEvaluator
from pfnl_tpu.models.pfnl import PFNL as JPFNL
from pfnl_tpu.train.losses import pfnl_loss as j_pfnl_loss
from pfnl_tpu.train.trainer import Trainer as JTrainer

from pfnl_tpu_torch.__main__ import _parser, main
from pfnl_tpu_torch.config import preset
from pfnl_tpu_torch.data.manifest import load_manifest
from pfnl_tpu_torch.data.pipeline import TrainPipeline
from pfnl_tpu_torch.eval.evaluator import Evaluator
from pfnl_tpu_torch.models.pfnl import PFNL
from pfnl_tpu_torch.ops.cuda import _build
from pfnl_tpu_torch.train.losses import pfnl_loss
from pfnl_tpu_torch.train.trainer import Trainer, polynomial_schedule
from pfnl_tpu_torch.utils.weights import from_flax
from tests.util_data import make_dataset


@pytest.mark.parametrize("name", ["pfnl", "vespcn", "ltdvsr", "mcresnet", "drvsr", "frvsr", "duf"])
def test_config_copy_matches_jax(name):
    assert dataclasses.asdict(preset(name)) == dataclasses.asdict(j_preset(name))
    assert preset(name, in_size=8).gt_size == j_preset(name, in_size=8).gt_size == 32


def _flax_pfnl(num_frames, num_blocks, x):
    jm = JPFNL(num_frames=num_frames, num_blocks=num_blocks)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    return jm, variables


def _port(variables, num_frames, num_blocks):
    model = PFNL(num_frames=num_frames, num_blocks=num_blocks)
    model.load_state_dict(from_flax(jax.tree_util.tree_map(np.asarray, variables["params"])))
    return model


def test_model_loss_and_gradients_match_flax():
    """PFNL(num_blocks=2) at (2,7,8,8,3): the loss, and every gradient
    within 1e-4 of its L2 norm."""
    rng = np.random.default_rng(8)
    x = rng.random((2, 7, 8, 8, 3)).astype(np.float32)
    gt = rng.random((2, 1, 32, 32, 3)).astype(np.float32)
    jm, variables = _flax_pfnl(7, 2, x)
    loss_of = lambda p: j_pfnl_loss(jm.apply({"params": p}, jnp.asarray(x)),  # noqa: E731
                                    jnp.asarray(gt), jnp.asarray(x))["loss"]
    want_loss, want = jax.value_and_grad(loss_of)(variables["params"])
    want = from_flax(jax.tree_util.tree_map(np.asarray, want))

    model = _port(variables, 7, 2)
    xt = torch.from_numpy(x)
    loss = pfnl_loss({"sr": model(xt)}, torch.from_numpy(gt), xt)["loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    grads = dict(model.named_parameters())
    assert sorted(grads) == sorted(want)
    for k, w in want.items():
        g = grads[k].grad
        assert ((g - w).norm() / w.norm()).item() <= 1e-4, k


def test_adam_with_polynomial_schedule_matches_optax(tmp_path):
    """Three updates from identical gradients against the JAX trainer's
    optax.scale_by_adam chain and schedule (trainer.py:97-105,177-182); the
    decay is short so the schedule moves and then clamps."""
    cfg = preset("pfnl", num_frames=3, learning_rate=1e-3, end_lr=1e-4, decay_step=2,
                 decay_power=0.9, reload=False)
    x = np.zeros((1, 3, 8, 8, 3), np.float32)
    jm, variables = _flax_pfnl(3, 1, x)
    jtr = JTrainer(cfg, workdir=str(tmp_path / "j"), model=jm)
    tx, params = jtr.txs[0], variables["params"]
    opt_state = tx.init(params)

    model = _port(variables, 3, 1)
    tr = Trainer(cfg, workdir=str(tmp_path / "t"), model=model, device="cpu")
    named = dict(model.named_parameters())
    rng = np.random.default_rng(1)
    for step in range(3):
        g = jax.tree_util.tree_map(
            lambda a: (rng.standard_normal(a.shape) * 0.1).astype(np.float32), params)
        updates, opt_state = tx.update(g, opt_state, params)
        lr_now = jtr.schedule(step)
        params = optax.apply_updates(params, jax.tree_util.tree_map(lambda u: u * lr_now, updates))
        for k, v in from_flax(g).items():
            named[k].grad = v
        assert tr.schedule(step) == pytest.approx(float(lr_now), rel=1e-6)
        tr.apply_gradients()
    assert tr.global_step == 3
    for k, w in from_flax(jax.tree_util.tree_map(np.asarray, params)).items():
        np.testing.assert_allclose(named[k].detach().numpy(), w.numpy(), atol=1e-6, err_msg=k)


def test_polynomial_schedule_endpoints():
    s = polynomial_schedule(1e-3, 1e-4, 1.0, 100)
    assert s(0) == 1e-3 and s(50) == pytest.approx(5.5e-4) and s(100) == s(250) == 1e-4


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("torchtrainer")
    filelist, _ = make_dataset(str(root), num_seqs=4, num_frames=20, hw=(48, 48))
    return filelist


def _cfg(filelist, tmp_path, **kw):
    return preset("pfnl", num_frames=3, in_size=8, batch_size=2, train_list=filelist,
                  eval_list=filelist, save_dir=str(tmp_path / "ckpt"), reload=False,
                  eval_in_size=(8, 8), eval_batch_size=2, host_threads=1, **kw)


def _pipe(cfg):
    return TrainPipeline(load_manifest(cfg.train_list), "single", cfg.num_frames, cfg.in_size,
                         cfg.scale, cfg.batch_size, num_threads=1, prefetch=2)


def test_trainer_fit_runs_and_does_not_diverge(dataset, tmp_path):
    """Like test_train_smoke.py::test_pfnl_train_smoke: fit, then more steps."""
    cfg = _cfg(dataset, tmp_path)
    tr = Trainer(cfg, model=PFNL(num_frames=3, num_blocks=2,
                                 generator=torch.Generator().manual_seed(0)), device="cpu")
    pipe = _pipe(cfg)
    printed = []
    try:
        tr.fit(pipe, max_steps=20, save_every=10, log_every=10, print_fn=printed.append)
        losses = [float(tr.step(pipe.get_batch(), tr.step_generator(s))["loss"])
                  for s in range(20, 35)]
    finally:
        pipe.close()
    assert tr.global_step == 35
    assert any(p.startswith("cost ") for p in printed)
    assert any("Step:10, loss:" in p for p in printed)
    assert [os.path.basename(p) for p in tr.checkpoints()] == ["ckpt_000000010.pt"]
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]) * 1.05


def test_checkpoint_resume_gives_the_same_next_step(dataset, tmp_path):
    cfg = _cfg(dataset, tmp_path)
    make = lambda seed: PFNL(num_frames=3, num_blocks=1,  # noqa: E731
                             generator=torch.Generator().manual_seed(seed))
    pipe = _pipe(cfg)
    try:
        b0, b1 = pipe.get_batch(), pipe.get_batch()
    finally:
        pipe.close()
    tr = Trainer(cfg, model=make(0), device="cpu")
    tr.step(b0, tr.step_generator(0))
    tr.save()
    want = float(tr.step(b1, tr.step_generator(1))["loss"])

    tr2 = Trainer(cfg, model=make(1), device="cpu")
    assert tr2.restore() and tr2.global_step == 1
    got = float(tr2.step(b1, tr2.step_generator(1))["loss"])
    assert got == pytest.approx(want, rel=1e-6)
    for a, b in zip(tr.model.parameters(), tr2.model.parameters()):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)
    for _ in range(6):  # the newest 5 are kept
        tr2.global_step += 1
        tr2.save()
    assert len(tr2.checkpoints()) == 5 and tr2.checkpoints()[-1].endswith("000000008.pt")


def test_fit_reloads_the_newest_checkpoint(dataset, tmp_path):
    cfg = _cfg(dataset, tmp_path)
    tr = Trainer(cfg, model=PFNL(num_frames=3, num_blocks=1), device="cpu")
    tr.global_step = 4
    tr.save()
    cfg.reload = True
    tr2 = Trainer(cfg, model=PFNL(num_frames=3, num_blocks=1), device="cpu")
    pipe = _pipe(cfg)
    try:
        tr2.fit(pipe, max_steps=6, print_fn=lambda *a: None)
    finally:
        pipe.close()
    assert tr2.global_step == 6


def test_evaluator_psnr_matches_jax(dataset, tmp_path):
    """One window per 20-frame sequence (centre 15), batch 2; within 1e-3 dB."""
    cfg = _cfg(dataset, tmp_path)
    jm, variables = _flax_pfnl(3, 2, np.zeros((1, 3, 8, 8, 3), np.float32))
    jlog, tlog = str(tmp_path / "j.txt"), str(tmp_path / "t.txt")
    want, _ = JEvaluator(cfg, jm).run(variables, 7, log_path=jlog, print_fn=lambda *a: None)
    printed = []
    got, _ = Evaluator(cfg, _port(variables, 3, 2)).run(7, log_path=tlog,
                                                        print_fn=printed.append)
    assert got.shape == (1,)
    np.testing.assert_allclose(got, want, atol=1e-3)
    assert any(p.startswith("Eval PSNR: [") for p in printed)
    with open(tlog) as f:
        line = f.read()
    assert line.startswith('{"Iter": 7 , "PSNR": [') and line.endswith("]}\n")


def test_cli_train_writes_checkpoints_and_log(dataset, tmp_path):
    save_dir = str(tmp_path / "cli")
    main(["train", "pfnl", "--train-list", dataset, "--eval-list", dataset, "--steps", "6",
          "--in-size", "8", "--batch-size", "2", "--save-dir", save_dir, "--save-every", "5",
          "--device", "cpu", "--compute-dtype", "bfloat16"])
    assert os.path.exists(os.path.join(save_dir, "ckpt_000000005.pt"))
    with open(os.path.join(save_dir, "pfnl.txt")) as f:
        assert f.read().count('"Iter": ') == 2   # eval at steps 0 and 5


# --- repairs ---------------------------------------------------------------


def test_cli_device_defaults_to_cuda():
    """No silent CPU fallback: the CPU runs only when asked for."""
    assert _parser().parse_args(["train", "pfnl"]).device == "cuda"
    assert _parser().parse_args(["test", "pfnl", "--data", "d"]).device == "cuda"


def test_kernel_guard_refuses_to_cut_a_graph():
    """What each wrapper checks on a CUDA tensor before its launch."""
    w = torch.zeros(3, requires_grad=True)
    x = torch.zeros(3)
    with pytest.raises(RuntimeError, match="autograd"):
        _build.check_no_grad("k", x, w)
    _build.check_no_grad("k", x, w.detach())
    with torch.no_grad():
        _build.check_no_grad("k", x, w)
    with torch.inference_mode():
        _build.check_no_grad("k", x, w)


def test_every_parameter_gets_a_gradient():
    model = PFNL(num_frames=3, num_blocks=2, generator=torch.Generator().manual_seed(0))
    x = torch.rand(1, 3, 8, 8, 3, generator=torch.Generator().manual_seed(1))
    pfnl_loss({"sr": model(x)}, torch.zeros(1, 1, 32, 32, 3), x)["loss"].backward()
    missing = [k for k, p in model.named_parameters() if p.grad is None or not p.grad.any()]
    assert not missing


@pytest.mark.parametrize("over", [dict(model="duf")])
def test_trainer_refuses_what_is_not_ported(over):
    """DUF trains; what a DUF training step refuses is a backbone of kernel 9
    (conv3d_impl="fused"), which folds the eval BatchNorms and has no
    training form (JAX's training never takes it either)."""
    from pfnl_tpu_torch.models import DUF

    cfg = preset("pfnl", **over, in_size=4, batch_size=1, producer="double")
    batch = {"lr": np.zeros((1, 7, 4, 4, 3), np.uint8), "gt": np.zeros((1, 1, 16, 16, 3), np.uint8)}
    tr = Trainer(cfg, model=DUF(layers=16), device="cpu")
    assert tr.loss_fn.__name__ == "duf_loss" and len(tr.optimizers) == 1
    assert np.isfinite(tr.step(batch, tr.step_generator(0))["loss"].item())
    tr = Trainer(cfg, model=DUF(layers=16, conv3d_impl="fused"), device="cpu")
    with pytest.raises(NotImplementedError, match="kernel 9"):
        tr.step(batch, tr.step_generator(0))
