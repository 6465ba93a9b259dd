"""Flow-family training in the port against the JAX package, on the CPU:
the splat adjoints against `_bsplat_bwd` / `_spmc_bwd` and against autograd
of the plain splats, the flow losses, each family's joint loss and every
parameter gradient against jax.grad (the JAX side runs kernels 7 and 8 in
interpret mode, jitted), the staged Adam against optax's multi_transform
and fresh second state, DRVSR's LSTM clip against optax.masked, a resume
across the stage switch, a bf16 step and `train vespcn` on the command
line.

Gradients are compared on parameters, never on input frames: jnp.clip's
gradient at a tie (a value exactly 0 or 1) is 0.5 where torch.clamp's is 1,
which reaches the frames of `backward_warp_local` but no parameter."""

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
from pfnl_tpu.models.drvsr import DRVSR as JDRVSR
from pfnl_tpu.models.frvsr import FRVSR as JFRVSR
from pfnl_tpu.models.ltdvsr import LTDVSR as JLTDVSR
from pfnl_tpu.models.mcresnet import MCResNet as JMCResNet
from pfnl_tpu.models.vespcn import VESPCN as JVESPCN
from pfnl_tpu.ops.warp import _bsplat_bwd, _spmc_bwd
from pfnl_tpu.train import losses as jlosses
from pfnl_tpu.train.trainer import Trainer as JTrainer, _lstm_mask

from pfnl_tpu_torch.__main__ import main
from pfnl_tpu_torch.config import preset
from pfnl_tpu_torch.models import DRVSR, FRVSR, LTDVSR, MCResNet, VESPCN
from pfnl_tpu_torch.ops import warp
from pfnl_tpu_torch.train import losses
from pfnl_tpu_torch.train.trainer import (LSTM_CLIP_NORM, Trainer, clip_by_global_norm_,
                                          is_flow_param, is_lstm_param)
from pfnl_tpu_torch.utils.weights import from_flax
from tests.test_torch_flows import random_params
from tests.util_data import make_dataset

# family -> (port class, flax class, frames, extra constructor arguments)
FAMILIES = {"vespcn": (VESPCN, JVESPCN, 3, {}), "mcresnet": (MCResNet, JMCResNet, 5, {}),
            "ltdvsr": (LTDVSR, JLTDVSR, 5, {}), "drvsr": (DRVSR, JDRVSR, 3, {}),
            "frvsr": (FRVSR, JFRVSR, 3, {"mf": 8, "num_blocks": 1})}
LR = 8  # LR side of every model case


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _flax(family, x, rng):
    _, jcls, t, kw = FAMILIES[family]
    jm = jcls(num_frames=t, **kw)
    return jm, random_params(jm, (jnp.asarray(x),), rng)


def _port(family, params):
    cls, _, t, kw = FAMILIES[family]
    model = cls(num_frames=t, **kw)
    model.load_state_dict(from_flax(_np_tree(params)))  # strict: every flax name fits
    return model


def _case(family, seed, b=2):
    """Seeded LR frames and GT (every frame's for FRVSR, the centre's else)."""
    t = FAMILIES[family][2]
    rng = np.random.default_rng(seed)
    x = rng.random((b, t, LR, LR, 3)).astype(np.float32)
    gt = rng.random((b, t if family == "frvsr" else 1, 4 * LR, 4 * LR, 3)).astype(np.float32)
    return rng, x, gt


# --------------------------------------------------------------- the adjoints

def _splat_case(seed, shape, r):
    rng = np.random.default_rng(seed)
    im = rng.random(shape).astype(np.float32)
    # |uv| <= r keeps every tap inside the acceptance window
    uv = (rng.uniform(-1, 1, shape[:3] + (2,)) * 0.97 * r).astype(np.float32)
    return rng, im, uv


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("c", [1, 3])
def test_bounded_splat_adjoint_matches_jax_and_autograd(r, c):
    rng, im, uv = _splat_case(10 * r + c, (2, 12, 16, c), r)
    g = rng.standard_normal((2, 12, 16, c)).astype(np.float32)
    d_im, d_uv = warp.bounded_splat_adjoint(_t(im), _t(uv), _t(g), r)
    want_im, want_uv = _bsplat_bwd(r, (jnp.asarray(im), jnp.asarray(uv)), jnp.asarray(g))
    np.testing.assert_allclose(d_im.numpy(), np.asarray(want_im), atol=1e-5)
    np.testing.assert_allclose(d_uv.numpy(), np.asarray(want_uv), atol=1e-5)
    imt, uvt = _t(im).requires_grad_(), _t(uv).requires_grad_()
    warp.forward_warp_local(imt, uvt, r).backward(_t(g))  # the plain splat on a CPU tensor
    np.testing.assert_allclose(d_im.numpy(), imt.grad.numpy(), atol=1e-5)
    np.testing.assert_allclose(d_uv.numpy(), uvt.grad.numpy(), atol=1e-5)
    assert d_im.dtype == d_uv.dtype == torch.float32


@pytest.mark.parametrize("r", [1, 2])
def test_spmc_splat_adjoint_matches_jax_and_autograd(r):
    rng, im, uv = _splat_case(20 + r, (2, 8, 12, 1), r)
    g = rng.standard_normal((2, 32, 48, 1)).astype(np.float32)
    d_im, d_uv = warp.spmc_splat_adjoint(_t(im), _t(uv), _t(g), 4, r)
    want_im, want_uv = _spmc_bwd(4, r, (jnp.asarray(im), jnp.asarray(uv)), jnp.asarray(g))
    np.testing.assert_allclose(d_im.numpy(), np.asarray(want_im), atol=1e-5)
    np.testing.assert_allclose(d_uv.numpy(), np.asarray(want_uv), atol=1e-5)
    imt, uvt = _t(im).requires_grad_(), _t(uv).requires_grad_()
    warp.forward_warp_spmc(imt, uvt, 4, r).backward(_t(g))
    np.testing.assert_allclose(d_im.numpy(), imt.grad.numpy(), atol=1e-5)
    np.testing.assert_allclose(d_uv.numpy(), uvt.grad.numpy(), atol=1e-5)


def test_splat_functions_differentiate_through_the_adjoints():
    """BoundedSplat / SpmcSplat, which ops/warp.py routes a CUDA call under
    grad to, applied here to CPU tensors (their forward is then the plain
    splat): the Functions' backward is the adjoint, equal to autograd."""
    from pfnl_tpu_torch.ops.cuda.bounded_splat import BoundedSplat
    from pfnl_tpu_torch.ops.cuda.spmc_splat import SpmcSplat

    rng, im, uv = _splat_case(7, (2, 8, 12, 1), 2)
    for fn, ref, g_hw in ((lambda i, u: BoundedSplat.apply(i, u, 2),
                           lambda i, u: warp.forward_warp_local_ref(i, u, 2), (8, 12)),
                          (lambda i, u: SpmcSplat.apply(i, u, 4, 2),
                           lambda i, u: warp.forward_warp_local_spmc(i, u, 4, 2), (32, 48))):
        g = _t(rng.standard_normal((2,) + g_hw + (1,)).astype(np.float32))
        got, want = [], []
        for f, acc in ((fn, got), (ref, want)):
            imt, uvt = _t(im).requires_grad_(), _t(uv).requires_grad_()
            out = f(imt, uvt)
            out.backward(g)
            acc += [out.detach(), imt.grad, uvt.grad]
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_adjoints_keep_the_inputs_dtypes():
    _, im, uv = _splat_case(3, (1, 8, 8, 1), 2)
    args = (_t(im).bfloat16(), _t(uv).bfloat16())
    for d_im, d_uv in (warp.bounded_splat_adjoint(*args, torch.ones(1, 8, 8, 1), 2),
                       warp.spmc_splat_adjoint(*args, torch.ones(1, 32, 32, 1), 4, 2)):
        assert d_im.dtype == d_uv.dtype == torch.bfloat16


# --------------------------------------------------------------- the losses

def _loss_inputs(family, seed):
    rng = np.random.default_rng(seed)
    b, t, h, w = 2, 3, 8, 8
    gt = rng.random((b, t if family == "frvsr" else 1, 4 * h, 4 * w, 3)).astype(np.float32)
    lr = rng.random((b, t, h, w, 3)).astype(np.float32)
    if family == "frvsr":
        out = {"sr": rng.random((b, t, 4 * h, 4 * w, 3)), "warps": rng.random((b, t - 1, h, w, 3))}
    else:
        out = {"sr": rng.random((b, t if family == "drvsr" else 1, 4 * h, 4 * w, 1)),
               "uv": rng.uniform(-1.9, 1.9, (b, t, h, w, 2)),
               "frames_y": rng.uniform(0.1, 0.9, (b, t, h, w, 1)),
               "ref_y": rng.uniform(0.1, 0.9, (b, h, w, 1))}
    return {k: v.astype(np.float32) for k, v in out.items()}, gt, lr


@pytest.mark.parametrize("family", ["vespcn", "drvsr", "frvsr"])
def test_flow_losses_match_jax(family):
    out, gt, lr = _loss_inputs(family, 5)
    want = jlosses.LOSS_REGISTRY[family]({k: jnp.asarray(v) for k, v in out.items()},
                                         jnp.asarray(gt), jnp.asarray(lr))
    got = losses.LOSS_REGISTRY[family]({k: _t(v) for k, v in out.items()}, _t(gt), _t(lr))
    assert set(got) <= set(want) and {"loss", "loss_sr"} <= set(got)
    for k, v in got.items():
        np.testing.assert_allclose(v.item(), float(want[k]), rtol=1e-5, err_msg=k)


def test_registry_covers_every_family_but_duf():
    """Since DUF trains (tests/test_torch_duf_train.py holds duf_loss), the
    registry is JAX's, DUF included."""
    assert sorted(losses.LOSS_REGISTRY) == sorted(jlosses.LOSS_REGISTRY)


# --------------------------------------------------------------- the models

@pytest.mark.parametrize("family", list(FAMILIES))
def test_model_loss_and_gradients_match_jax(family):
    """The joint loss within rtol 1e-5 and every parameter gradient within
    1e-4 of its L2 norm, against jax.grad of the flax model + loss."""
    rng, x, gt = _case(family, 30)
    jm, params = _flax(family, x, rng)
    jloss = jlosses.LOSS_REGISTRY[family]
    loss_of = lambda p: jloss(jm.apply({"params": p}, jnp.asarray(x)),  # noqa: E731
                              jnp.asarray(gt), jnp.asarray(x))["loss"]
    want_loss, want = jax.jit(jax.value_and_grad(loss_of))(params)
    want = from_flax(_np_tree(want))

    model = _port(family, params)
    loss = losses.LOSS_REGISTRY[family](model(_t(x)), _t(gt), _t(x))["loss"]
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    grads = dict(model.named_parameters())
    assert sorted(grads) == sorted(want)
    for k, w in want.items():
        assert ((grads[k].grad - w).norm() / w.norm()).item() <= 1e-4, k


# --------------------------------------------------------------- the optimizer

def _grads_like(params, rng, scale):
    return jax.tree_util.tree_map(
        lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32), params)


def test_staged_adam_matches_optax_over_the_switch(tmp_path):
    """DRVSR, switch at step 2: steps 0-1 through the SR stage's
    multi_transform (flow set to zero, LSTM clipped), steps 2-3 through the
    joint Adam from its fresh state, fed the same gradients; the LSTM's
    norm is above 3 at steps 0 and 2 and below it at 1 and 3."""
    cfg = preset("drvsr", stage_switch_step=2, learning_rate=1e-3, end_lr=1e-4, decay_step=3,
                 reload=False)
    x = np.zeros((1, 3, LR, LR, 3), np.float32)
    jm, params = _flax("drvsr", x, np.random.default_rng(40))
    jtr = JTrainer(j_preset("drvsr", **{k: getattr(cfg, k) for k in (
        "stage_switch_step", "learning_rate", "end_lr", "decay_step", "reload")}),
        workdir=str(tmp_path / "j"), model=jm)
    opt_states = [tx.init(params) for tx in jtr.txs]

    tr = Trainer(cfg, workdir=str(tmp_path / "t"), model=_port("drvsr", params), device="cpu")
    named = dict(tr.model.named_parameters())
    flow0 = {k: p.detach().clone() for k, p in named.items() if is_flow_param(k)}
    assert flow0 and all(k.startswith("easyflow.") for k in flow0)
    assert [k for k in named if is_lstm_param(k)] == [k for k in named if ".lstm." in k]
    rng = np.random.default_rng(41)
    for step, scale in enumerate((1.0, 1e-3, 1.0, 1e-3)):
        stage = int(step >= 2)
        assert tr.stage == stage
        g = _grads_like(params, rng, scale)
        updates, opt_states[stage] = jtr.txs[stage].update(g, opt_states[stage], params)
        lr_now = jtr.schedule(step)
        params = optax.apply_updates(params, jax.tree_util.tree_map(lambda u: u * lr_now, updates))
        for k, v in from_flax(g).items():
            named[k].grad = v
        tr.apply_gradients()
        if step == 1:  # the SR stage never moves the flow net
            assert all(torch.equal(named[k], v) for k, v in flow0.items())
            assert not tr.optimizers[1].state_dict()["state"]  # the joint Adam is still fresh
    assert tr.global_step == 4 and tr.stage == 1
    assert not all(torch.equal(named[k], v) for k, v in flow0.items())
    for k, w in from_flax(_np_tree(params)).items():
        np.testing.assert_allclose(named[k].detach().numpy(), w.numpy(), atol=1e-6, err_msg=k)


@pytest.mark.parametrize("scale", [1e-3, 1.0])
def test_lstm_clip_matches_optax_masked(scale):
    """Below and above the LSTM gradients' global norm of 3; the rest untouched."""
    tree = {"srmodel": {"lstm": {"kernel": np.zeros((3, 3, 8, 16), np.float32),
                                 "bias": np.zeros(16, np.float32)},
                        "enc1": {"kernel": np.zeros((5, 5, 1, 8), np.float32)}}}
    g = _grads_like(tree, np.random.default_rng(42), scale)
    tx = optax.masked(optax.clip_by_global_norm(LSTM_CLIP_NORM), _lstm_mask)
    want, _ = tx.update(g, tx.init(tree))
    flat = {k: v.clone() for k, v in from_flax(g).items()}
    norm = float(torch.sqrt(sum((v ** 2).sum() for k, v in flat.items() if is_lstm_param(k))))
    assert (norm > LSTM_CLIP_NORM) == (scale == 1.0)
    clip_by_global_norm_([v for k, v in flat.items() if is_lstm_param(k)], LSTM_CLIP_NORM)
    for k, w in from_flax(_np_tree(want)).items():
        np.testing.assert_allclose(flat[k].numpy(), w.numpy(), rtol=1e-6, atol=1e-8, err_msg=k)


def _double_batches(rng, n, t=3, b=2):
    """uint8 "double"-producer batches: LR frames and the centre GT."""
    return [{"lr": (rng.random((b, t, LR, LR, 3)) * 255).astype(np.uint8),
             "gt": (rng.random((b, 1, 4 * LR, 4 * LR, 3)) * 255).astype(np.uint8)}
            for _ in range(n)]


@pytest.mark.parametrize("saved_at", [1, 2])
def test_resume_across_the_switch_gives_the_same_next_step(tmp_path, saved_at):
    """VESPCN switching at step 1: a checkpoint at step 1 (the joint Adam
    still fresh) or 2 (its first moments written) resumes to the same steps."""
    cfg = preset("vespcn", stage_switch_step=1, save_dir=str(tmp_path / "ck"), reload=False,
                 in_size=LR, batch_size=2)
    batches = _double_batches(np.random.default_rng(43), 4)
    make = lambda seed: VESPCN(num_frames=3, generator=torch.Generator().manual_seed(seed))  # noqa: E731
    tr = Trainer(cfg, model=make(0), device="cpu")
    for step in range(saved_at):
        tr.step(batches[step], tr.step_generator(step))
    tr.save()
    want = [float(tr.step(batches[s], tr.step_generator(s))["loss"]) for s in range(saved_at, 4)]

    tr2 = Trainer(cfg, model=make(1), device="cpu")
    assert tr2.restore() and tr2.global_step == saved_at and tr2.stage == 1
    got = [float(tr2.step(batches[s], tr2.step_generator(s))["loss"]) for s in range(saved_at, 4)]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    for a, b in zip(tr.model.parameters(), tr2.model.parameters()):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_bf16_vespcn_step_keeps_float32_parameters():
    cfg = preset("vespcn", compute_dtype="bfloat16", reload=False, in_size=LR, batch_size=2)
    tr = Trainer(cfg, device="cpu")
    before = [p.detach().clone() for p in tr.model.parameters()]
    out = tr.step(_double_batches(np.random.default_rng(44), 1)[0], tr.step_generator(0))
    assert np.isfinite(float(out["loss"])) and tr.global_step == 1
    assert all(p.dtype == torch.float32 for p in tr.model.parameters())
    moved = [not torch.equal(a, p) for a, p in zip(before, tr.model.parameters())]
    assert any(moved)


def test_trainer_builds_every_flow_family_from_its_preset():
    for family, (cls, _, t, _) in FAMILIES.items():
        tr = Trainer(preset(family, num_frames=t), device="cpu")
        assert type(tr.model) is cls and tr.model.num_frames == t
        assert len(tr.optimizers) == (1 if family == "frvsr" else 2)
        assert bool(tr.clipped) == (family == "drvsr")


def test_cli_train_vespcn_writes_a_checkpoint(tmp_path):
    filelist, _ = make_dataset(str(tmp_path / "ds"), num_seqs=2, num_frames=8, hw=(48, 48))
    save_dir = str(tmp_path / "ck")
    main(["train", "vespcn", "--train-list", filelist, "--steps", "2", "--in-size", str(LR),
          "--batch-size", "2", "--save-dir", save_dir, "--save-every", "1", "--no-eval",
          "--device", "cpu"])
    assert [os.path.basename(p) for p in glob.glob(os.path.join(save_dir, "ckpt_*.pt"))] == [
        "ckpt_000000001.pt"]
    state = torch.load(os.path.join(save_dir, "ckpt_000000001.pt"), weights_only=True)
    assert state["step"] == 1 and len(state["optimizers"]) == 2
