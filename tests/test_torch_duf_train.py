"""DUF training in the port against the JAX package, on the CPU: `huber`'s
value and gradient (at |e| = delta and e = 0 too) against jax.grad,
`RefBatchNorm`'s training branch (output, input gradient and the five
buffers after 1, 2 and 3 updates) against flax `mutable=["batch_stats"]`,
the `auto` rule of the backbone, the kernel-10 path's gradients
(`Conv3x3x3`, whose CPU forward is its plain version) against the plain
path's, two `Trainer` steps of DUF-16L against the JAX `Trainer`, the legacy
checkpoint's shadows, and `train duf` on the command line.  float32 on both
sides; each test states its tolerance."""

import glob
import os

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

torch.set_num_threads(2)

from pfnl_tpu.config import preset as j_preset
from pfnl_tpu.models.duf import DUF as JDUF, RefBatchNorm as JRefBatchNorm
from pfnl_tpu.ops.losses import huber as j_huber
from pfnl_tpu.train.trainer import Trainer as JTrainer

from pfnl_tpu_torch.__main__ import main
from pfnl_tpu_torch.config import preset
from pfnl_tpu_torch.models import DUF
from pfnl_tpu_torch.models.duf import RefBatchNorm, bn_cancelled_bias
from pfnl_tpu_torch.ops.losses import huber
from pfnl_tpu_torch.train.losses import LOSS_REGISTRY
from pfnl_tpu_torch.train.trainer import (BN_SHADOWS, LEGACY_LOCAL_STEP, Trainer,
                                          save_checkpoint)
from pfnl_tpu_torch.utils.weights import from_flax
from tests.util_data import make_dataset

LR = 8  # LR side of every DUF case


def _t(a):
    return torch.from_numpy(np.array(a, np.float32))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


# ------------------------------------------------------------------- huber

def test_huber_value_and_gradient_match_jax():
    """Errors on both sides of delta, exactly at +-delta and exactly 0:
    the value to 1e-7 relative and the gradient in both arguments to 1e-7
    (jnp.minimum splits a tie's gradient half and half, so does
    torch.minimum; |e|'s gradient at 0 is 0 in both)."""
    delta = 0.25  # a power of two: y_pred - y_true lands exactly on +-delta
    y_true = np.array([0.0, 0.5, 1.0, 0.125, 0.5, 0.75, 0.3, 2.0], np.float32)
    e = np.array([0.0, delta, -delta, 0.1, -0.05, 0.6, -1.3, 0.0], np.float32)
    y_pred = y_true + e
    assert np.array_equal(np.abs(y_pred - y_true)[1:3], [delta, delta])

    want, (jg_t, jg_p) = jax.value_and_grad(j_huber, argnums=(0, 1))(
        jnp.asarray(y_true), jnp.asarray(y_pred), delta)
    t, p = _t(y_true).requires_grad_(), _t(y_pred).requires_grad_()
    got = huber(t, p, delta)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-7)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jg_p), rtol=1e-7, atol=1e-9)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jg_t), rtol=1e-7, atol=1e-9)
    assert p.grad[0] == 0 and p.grad[-1] == 0  # e = 0
    # the tie: half of the quadratic's slope delta plus half of the linear's delta
    np.testing.assert_allclose(p.grad[1].item(), delta / len(e), rtol=1e-7)


def test_duf_loss_matches_jax_and_is_registered():
    from pfnl_tpu.train.losses import duf_loss as j_duf_loss

    rng = np.random.default_rng(1)
    sr = rng.random((2, 1, 16, 16, 3)).astype(np.float32)
    gt = sr + rng.normal(0, 0.02, sr.shape).astype(np.float32)
    want = j_duf_loss({"sr": jnp.asarray(sr)}, jnp.asarray(gt), None)
    got = LOSS_REGISTRY["duf"]({"sr": _t(sr)}, _t(gt), None)
    assert set(got) == set(want) == {"loss", "loss_sr"}
    for k in got:
        np.testing.assert_allclose(got[k].item(), float(want[k]), rtol=1e-6)


# ------------------------------------------------------- the training BatchNorm

def test_ref_batchnorm_training_matches_flax_over_three_updates():
    """From non-zero shadows and local_step 0: each training forward's
    output and input gradient, and all five buffers after it, against flax
    with mutable=["batch_stats"] (1e-6)."""
    rng = np.random.default_rng(2)
    feats = 24
    params = {"beta": rng.normal(0, 0.1, feats), "gamma": 1 + rng.normal(0, 0.1, feats)}
    stats = {"moving_mean": rng.normal(0, 0.1, feats), "moving_variance": rng.random(feats),
             "biased_mean": rng.normal(0, 0.1, feats), "biased_var": rng.random(feats) * 0.1,
             "local_step": 0.0}
    params = {k: np.asarray(v, np.float32) for k, v in params.items()}
    stats = {k: np.asarray(v, np.float32) for k, v in stats.items()}
    jm = JRefBatchNorm(feats)
    m = RefBatchNorm(feats)
    m.load_state_dict(from_flax(params, stats))
    m.train()
    for update in range(1, 4):
        x = (rng.normal(0.3 * update, 1.0 + update, (2, 3, 5, 4, feats))).astype(np.float32)
        cot = rng.standard_normal(x.shape).astype(np.float32)

        def f(xx, st=stats):
            out, mut = jm.apply({"params": params, "batch_stats": st}, xx, True,
                                mutable=["batch_stats"])
            return jnp.sum(out * cot), (out, mut["batch_stats"])

        (_, (jout, stats)), jgx = jax.value_and_grad(f, has_aux=True)(jnp.asarray(x))
        stats = _np_tree(stats)
        xt = _t(x).requires_grad_()
        out = m(xt)
        (out * _t(cot)).sum().backward()
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), rtol=1e-6, atol=1e-6)
        assert float(stats["local_step"]) == update == m.local_step.item()
        for k, v in stats.items():
            np.testing.assert_allclose(getattr(m, k).numpy(), v, rtol=1e-6, atol=1e-7,
                                       err_msg=f"{k} after {update}")
    # the moving statistics are debiased: after an update they track the batch's
    assert not np.allclose(stats["moving_variance"], stats["biased_var"])


def test_ref_batchnorm_eval_mode_updates_nothing_and_no_grad_training_does():
    m = RefBatchNorm(8)
    x = torch.randn(4, 3, 3, 8, generator=torch.Generator().manual_seed(3))
    m.eval()
    with torch.no_grad():
        m(x)
    assert m.local_step.item() == 0 and not m.biased_mean.any()
    m.train()
    with torch.no_grad():  # JAX's is_train=True updates whatever the caller differentiates
        m(x)
        # debiased: after one update the moving statistics are the batch's
        # (to float32's rounding of 0.999: 1 - 0.999f is 1.3e-5 off 0.001f)
        torch.testing.assert_close(m.moving_mean, x.mean((0, 1, 2)), rtol=1e-4, atol=1e-6)
        torch.testing.assert_close(m.moving_variance, x.var((0, 1, 2), unbiased=False),
                                   rtol=1e-4, atol=1e-6)
        y = m(x.bfloat16())
    assert m.local_step.item() == 2 and y.dtype == torch.bfloat16


# ---------------------------------------------------------- the backbone's path

def test_auto_takes_kernel_9_only_in_eval_mode_without_grad():
    """JAX: "fused" on the accelerator when not is_train.  On the card the
    port's auto rule takes kernel 9 in eval mode under no_grad, and the
    plain path in training mode (under no_grad too) or with grad on; a CPU
    tensor never launches a kernel.  conv3d_impl="fused" does not train."""
    g = DUF(layers=16).G
    g.eval()
    with torch.no_grad():
        assert g.backbone_impl(on_cuda=True) == "fused"
        assert g.backbone_impl(on_cuda=True, plain=True) == "xla"
        assert g.backbone_impl(on_cuda=False) == "xla"
    assert g.backbone_impl(on_cuda=True) == "xla"  # grad on: kernel 9 has no backward
    g.train()
    with torch.no_grad():
        assert g.backbone_impl(on_cuda=True) == "xla"
    assert g.backbone_impl(on_cuda=True) == "xla"
    fused = DUF(layers=16, conv3d_impl="fused").train()
    with pytest.raises(NotImplementedError, match="kernel 9"):
        fused(torch.zeros(1, 7, 4, 4, 3))


def test_kernel_10_path_gradients_match_the_plain_path():
    """DUF-16L with conv3d_impl="pallas" (every padded growth conv through
    `Conv3x3x3`: its forward, and its backward as the plain conv's VJP) and
    the plain path, from the same weights in training mode: the loss, every
    parameter's gradient and the BatchNorm buffers after the step (1e-6)."""
    rng = np.random.default_rng(4)
    x = _t(rng.random((2, 7, LR, LR, 3)))
    gt = _t(rng.random((2, 1, 4 * LR, 4 * LR, 3)))
    res = {}
    for impl in ("pallas", "xla"):
        model = DUF(layers=16, conv3d_impl=impl, generator=torch.Generator().manual_seed(5))
        loss = LOSS_REGISTRY["duf"]({"sr": model(x)}, gt, x)["loss"]
        loss.backward()
        res[impl] = (loss.item(), {k: p.grad for k, p in model.named_parameters()},
                     dict(model.named_buffers()))
    assert res["pallas"][0] == pytest.approx(res["xla"][0], rel=1e-6)
    for k, g in res["xla"][1].items():
        torch.testing.assert_close(res["pallas"][1][k], g, rtol=1e-5, atol=1e-9, msg=k)
    for k, b in res["xla"][2].items():
        torch.testing.assert_close(res["pallas"][2][k], b, rtol=1e-6, atol=1e-7, msg=k)


# ------------------------------------------------------------------ the Trainer

def _double_batches(rng, n, b=2, t=7):
    return [{"lr": (rng.random((b, t, LR, LR, 3)) * 255).astype(np.uint8),
             "gt": (rng.random((b, 1, 4 * LR, 4 * LR, 3)) * 255).astype(np.uint8)}
            for _ in range(n)]



def test_two_trainer_steps_match_the_jax_trainer(tmp_path):
    """DUF-16L at LR 8x8, batch 2, the "double" producer (a pass-through on
    the device, so both trainers see the same frames), each step from the
    JAX Trainer's state (parameters, BatchNorm buffers, Adam moments and
    count).  The JAX step is the body of the JAX Trainer's `_make_step`
    (its `_apply`, loss, optimizer and schedule), jitted, returning its
    gradients too.  Held: the loss (1e-4: jitted, XLA's CPU fusions put
    JAX's loss 4.3e-5 off the same function run op by op, which the port
    matches to 3e-7), the step's gradients (each within 1e-4 of its L2 norm
    at the first step and 1e-2 at the second, where JAX's own float32
    gradients of conv1.W and Rbn1a.beta are 5.4e-3 and 6.3e-3 off a float64
    evaluation, jitted or not, and the port's 8.5e-6 and 9.2e-6; the biases
    a BatchNorm cancels, 0 in exact arithmetic and about 2e-10 in float32,
    within 1e-9), the five BatchNorm
    buffers after it (1e-5), and each parameter after it within 1e-6 of
    optax's update (the JAX Trainer's own Adam, state and schedule) applied
    to the port's own gradients.  The update is held apart from the
    gradients' rounding because the step is ill-conditioned in float32 (the
    port's own gradients with the batch order reversed move an element of
    2.8e-8 across 0, and Adam normalises it to +-lr), so no independent
    float32 trainer holds every parameter to JAX's parameters at a fixed
    1e-5; the update itself, moments and bias correction included, is
    held at 1e-6."""
    over = dict(in_size=LR, batch_size=2, reload=False)
    jtr = JTrainer(j_preset("duf", **over), workdir=str(tmp_path / "j"), model=JDUF(layers=16))
    batches = _double_batches(np.random.default_rng(6), 2)
    state = jtr.init_state(jax.random.PRNGKey(0), batches[0]["lr"].astype(np.float32) / 255)
    tr = Trainer(preset("duf", **over), workdir=str(tmp_path / "t"), model=DUF(layers=16),
                 device="cpu")
    named = dict(tr.model.named_parameters())

    @jax.jit
    def jax_step(state, lr_in, gt):
        def loss_of(params):
            out, new_bs = jtr._apply(params, state.batch_stats, lr_in, train=True)
            losses = jtr.loss_fn(out, gt, lr_in)
            return losses["loss"], (losses, new_bs)

        grads, (losses, new_bs) = jax.grad(loss_of, has_aux=True)(state.params)
        updates, new_opt = jtr.txs[0].update(grads, state.opt_states[0], state.params)
        lr_now = jtr.schedule(state.step)
        params = optax.apply_updates(state.params,
                                     jax.tree_util.tree_map(lambda u: u * lr_now, updates))
        return state.replace(step=state.step + 1, params=params, batch_stats=new_bs,
                             opt_states=(new_opt,)), losses, grads

    @jax.jit
    def optax_step(state, grads):
        updates, _ = jtr.txs[0].update(grads, state.opt_states[0], state.params)
        lr_now = jtr.schedule(state.step)
        return optax.apply_updates(state.params,
                                   jax.tree_util.tree_map(lambda u: u * lr_now, updates))

    for step, batch in enumerate(batches):
        before = state
        tr.model.load_state_dict(from_flax(_np_tree(state.params), _np_tree(state.batch_stats)))
        tr.global_step = step
        adam = state.opt_states[0][0]
        if step:
            mu, nu = from_flax(_np_tree(adam.mu)), from_flax(_np_tree(adam.nu))
            for k, p in named.items():
                tr.optimizer.state[p] = {"step": torch.tensor(float(adam.count)),
                                         "exp_avg": mu[k], "exp_avg_sq": nu[k]}
        state, jl, jg = jax_step(state, *(jnp.asarray(batch[k], jnp.float32) / 255
                                          for k in ("lr", "gt")))
        losses = tr.step(batch, tr.step_generator(step))
        np.testing.assert_allclose(losses["loss"].item(), float(jl["loss"]), rtol=1e-4)
        want_g = from_flax(_np_tree(jg))
        for k, p in named.items():
            err = (p.grad - want_g[k]).norm().item()
            rtol = (1e-4, 1e-2)[step]
            bound = 1e-9 if bn_cancelled_bias(k) else rtol * want_g[k].norm().item()
            assert err <= bound, (step, k, err, bound)
        paths, tree = jax.tree_util.tree_flatten_with_path(jg)
        port_g = jax.tree_util.tree_unflatten(tree, [
            jnp.asarray(named[".".join(str(key.key) for key in path)].grad.numpy())
            for path, _ in paths])
        want = from_flax(_np_tree(optax_step(before, port_g)), _np_tree(state.batch_stats))
        got = tr.model.state_dict()
        assert set(got) == set(want)
        for k, w in want.items():
            tol = 1e-6 if k in named else 1e-5
            np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=tol, atol=tol,
                                       err_msg=f"{k} after step {step}")
        assert got["G.Rbn1a.local_step"].item() == step + 1


def test_legacy_checkpoint_seeds_the_shadows_and_other_gaps_raise(tmp_path):
    """A checkpoint without the three shadows of some BatchNorms loads them
    from the moving statistics with local_step 1e7 (JAX
    `_restore_legacy_bn`); one missing anything else raises."""
    cfg = preset("duf", save_dir=str(tmp_path / "legacy"), reload=False)
    src = DUF(layers=16, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        for name, b in src.named_buffers():
            b.copy_(torch.rand(b.shape) + 0.5)
    full = src.state_dict()
    legacy = {k: v for k, v in full.items() if not k.endswith(BN_SHADOWS)}
    assert len(full) - len(legacy) == 3 * sum(k.endswith(".local_step") for k in full)
    save_checkpoint(cfg.save_dir, {"step": 3, "model": legacy})
    tr = Trainer(cfg, model=DUF(layers=16), device="cpu")
    assert tr.restore() and tr.global_step == 3
    got = tr.model.state_dict()
    for k, v in legacy.items():
        assert torch.equal(got[k], v), k
    for bn in {k.rsplit(".", 1)[0] for k in full if k.endswith(".local_step")}:
        assert torch.equal(got[f"{bn}.biased_mean"], legacy[f"{bn}.moving_mean"])
        assert torch.equal(got[f"{bn}.biased_var"], legacy[f"{bn}.moving_variance"])
        assert got[f"{bn}.local_step"].item() == LEGACY_LOCAL_STEP

    for gap in ("G.Rbn2b.moving_mean", "G.conv1.W"):
        bad = {k: v for k, v in legacy.items() if k != gap}
        save_checkpoint(cfg.save_dir, {"step": 4 + len(gap), "model": bad})
        with pytest.raises(RuntimeError, match="Missing key"):
            Trainer(cfg, model=DUF(layers=16), device="cpu").restore()
    # one shadow missing, not all three: not the legacy layout
    bad = {k: v for k, v in full.items() if k != "G.fbn1.local_step"}
    save_checkpoint(cfg.save_dir, {"step": 40, "model": bad})
    with pytest.raises(RuntimeError, match="G.fbn1.local_step"):
        Trainer(cfg, model=DUF(layers=16), device="cpu").restore()


def test_cli_train_duf_trains_evaluates_and_resumes(tmp_path):
    """`train duf --device cpu` (DUF-52L at LR 8x8, batch 2): three steps,
    a checkpoint at step 2 holding the BatchNorm buffers of two training
    forwards, evaluations (eval mode, which updates nothing) logged at steps
    0 and 2; then a resume from that checkpoint."""
    filelist, _ = make_dataset(str(tmp_path / "ds"), num_seqs=4, num_frames=20, hw=(48, 48))
    save_dir = str(tmp_path / "ck")
    args = ["train", "duf", "--train-list", filelist, "--eval-list", filelist,
            "--eval-in-size", f"{LR}x{LR}", "--in-size", str(LR), "--batch-size", "2",
            "--save-dir", save_dir, "--save-every", "2", "--device", "cpu"]
    main(args + ["--steps", "3"])
    ckpts = sorted(os.path.basename(p) for p in glob.glob(os.path.join(save_dir, "ckpt_*.pt")))
    assert ckpts == ["ckpt_000000002.pt"]
    state = torch.load(os.path.join(save_dir, ckpts[0]), weights_only=True)
    assert state["model"]["G.Rbn24b.local_step"].item() == 2.0
    assert state["model"]["G.Rbn24b.moving_variance"].abs().sum() > 0
    log = open(os.path.join(save_dir, "duf.txt")).read().splitlines()
    assert [line.split(",")[0] for line in log] == ['{"Iter": 0 ', '{"Iter": 2 ']
    main(args + ["--steps", "4"])  # resumes from the checkpoint at step 2 (reload=True)
    log = open(os.path.join(save_dir, "duf.txt")).read().splitlines()
    assert [line.split(",")[0] for line in log] == ['{"Iter": 0 ', '{"Iter": 2 ', '{"Iter": 2 ']
