"""EasyFlow pre-training in the port against the JAX package, on the CPU:
`easyflow_loss`'s value and gradients against jax.grad, four
`EasyFlowTrainer` steps from JAX's initial parameters on a tiny PNG dataset
against JAX's `EasyFlowTrainer` (the same crops from the same seed, the
same metrics.jsonl steps and keys, every parameter within 1e-5), the same
run from in-memory sequences, and `restore_easyflow_params` handing the
result to a VESPCN that the Trainer then trains."""

import glob
import json
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from pfnl_tpu.models.flows import EasyFlow as JEasyFlow
from pfnl_tpu.train.easyflow_trainer import (EasyFlowTrainer as JEasyFlowTrainer,
                                             easyflow_loss as j_easyflow_loss)

from pfnl_tpu_torch.config import preset
from pfnl_tpu_torch.data.frames import MemoryFrames, PngFrames
from pfnl_tpu_torch.models import VESPCN
from pfnl_tpu_torch.models.flows import EasyFlow
from pfnl_tpu_torch.train.easyflow_trainer import (EasyFlowTrainer, easyflow_loss,
                                                   restore_easyflow_params)
from pfnl_tpu_torch.train.trainer import Trainer
from pfnl_tpu_torch.utils.weights import from_flax
from tests.util_data import make_dataset

CROP, FRAMES, BATCH, STEPS = 24, 3, 2, 4


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _init_params(seed=0):
    """The JAX trainer's initial parameters (its `train`'s init)."""
    z = jnp.zeros((1, CROP, CROP, 1))
    return JEasyFlow().init(jax.random.PRNGKey(seed), z, z)["params"]


def _port_model(params):
    model = EasyFlow()
    model.load_state_dict(from_flax(_np_tree(params)))
    return model


def test_easyflow_loss_value_and_gradients_match_jax():
    """The loss, its two parts (1e-5) and every parameter's gradient
    within 1e-4 of its L2 norm."""
    rng = np.random.default_rng(0)
    frames_y = rng.random((2, FRAMES, CROP, CROP, 1)).astype(np.float32)
    params = _init_params(1)
    (want, (wd, wt)), jg = jax.value_and_grad(j_easyflow_loss, has_aux=True)(
        params, JEasyFlow(), jnp.asarray(frames_y))
    model = _port_model(params)
    loss, (ld, lt) = easyflow_loss(model, torch.from_numpy(frames_y))
    loss.backward()
    for got, w in ((loss, want), (ld, wd), (lt, wt)):
        np.testing.assert_allclose(got.item(), float(w), rtol=1e-5)
    for k, g in from_flax(_np_tree(jg)).items():
        p = dict(model.named_parameters())[k]
        assert (p.grad - g).norm() <= 1e-4 * g.norm(), k


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("easyflow")
    filelist, seq_dirs = make_dataset(str(root), num_seqs=2, num_frames=8, hw=(40, 40))
    return filelist, seq_dirs


def _train_kwargs(save_dir, **kw):
    return dict(save_dir=save_dir, num_frames=FRAMES, crop_size=CROP, batch_size=BATCH,
                max_steps=STEPS, subdir="truth", **kw)


def _metrics(save_dir):
    with open(os.path.join(save_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_four_steps_match_the_jax_trainer(dataset, tmp_path):
    """From JAX's initial parameters and the same seed: the same batches
    (the same draws from default_rng), every parameter after four steps
    within 1e-5, the metrics.jsonl lines at the same steps with the same
    keys (the losses to 1e-5), the summary PNGs, and the last step's
    checkpoint."""
    filelist, _ = dataset
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jtr = JEasyFlowTrainer(train_list=filelist, **_train_kwargs(jdir))
    jparams = jtr.train(print_fn=lambda *a: None, save_every=STEPS, summary_every=2,
                        image_summary_every=2)
    tr = EasyFlowTrainer(train_list=filelist, device="cpu", **_train_kwargs(tdir))
    tr.model.load_state_dict(_port_model(_init_params()).state_dict())
    jseqs, seqs = jtr._sequences(), tr._sequences()
    assert seqs == jseqs
    np.testing.assert_array_equal(tr.sample_batch(np.random.default_rng(0), seqs),
                                  jtr.sample_batch(np.random.default_rng(0), jseqs))
    lines = []
    model = tr.train(print_fn=lines.append, save_every=STEPS, summary_every=2,
                     image_summary_every=2)
    assert [line.split(": ", 1)[1].split(",")[0] for line in lines] == ["step 0"]
    for k, w in from_flax(_np_tree(jparams)).items():
        np.testing.assert_allclose(dict(model.named_parameters())[k].detach().numpy(),
                                   w.numpy(), rtol=1e-5, atol=1e-5, err_msg=k)
    got, want = _metrics(tdir), _metrics(jdir)
    assert [m["step"] for m in got] == [m["step"] for m in want] == [0, 2]
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in ("loss", "photometric", "tv", "lr"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
    names = sorted(os.path.basename(p) for p in glob.glob(os.path.join(tdir, "summaries", "*")))
    assert names == sorted(f"{s:08d}_{n}.png" for s in (0, 2) for n in ("input", "warp", "flow"))
    assert [os.path.basename(p) for p in glob.glob(os.path.join(tdir, "step_*.pt"))] == [
        f"step_{STEPS - 1:08d}.pt"]


def test_in_memory_sequences_train_as_the_pngs_do(dataset, tmp_path):
    """`sequences=` with a MemoryFrames store of the same frames gives the
    same parameters as the filelist run, bitwise; summaries off."""
    filelist, seq_dirs = dataset
    runs = []
    for in_memory in (False, True):
        kw = {}
        if in_memory:
            paths = [PngFrames.list(os.path.join(d, "truth")) for d in seq_dirs]
            kw = dict(source=MemoryFrames({p: PngFrames.read(p) for s in paths for p in s}),
                      sequences=paths)
        tr = EasyFlowTrainer(train_list=None if in_memory else filelist, device="cpu",
                             seed=3, **_train_kwargs(str(tmp_path / str(in_memory)), **kw))
        tr.model.load_state_dict(_port_model(_init_params()).state_dict())
        runs.append(tr.train(max_steps=2, print_fn=lambda *a: None, image_summary_every=0))
    for a, b in zip(runs[0].parameters(), runs[1].parameters()):
        assert torch.equal(a, b)
    assert not glob.glob(str(tmp_path / "True" / "summaries"))


def test_restore_easyflow_params_hands_the_flow_to_vespcn(tmp_path):
    """The newest step_*.pt loads into VESPCN's `easyflow`, the rest of the
    model untouched; the Trainer then takes a step from it."""
    save_dir = str(tmp_path / "ef")
    ef = EasyFlowTrainer(device="cpu", save_dir=save_dir, seed=5)
    ef.save(0)
    gen = torch.Generator().manual_seed(6)
    with torch.no_grad():
        for p in ef.model.parameters():
            p.add_(torch.randn(p.shape, generator=gen) * 0.01)
    ef.save(7)
    model = VESPCN(num_frames=3, generator=torch.Generator().manual_seed(1))
    sr_before = {k: v.clone() for k, v in model.state_dict().items()
                 if not k.startswith("easyflow.")}
    assert restore_easyflow_params(save_dir, model) is model
    for k, v in ef.model.state_dict().items():
        assert torch.equal(model.easyflow.state_dict()[k], v), k
    for k, v in sr_before.items():
        assert torch.equal(model.state_dict()[k], v), k
    cfg = preset("vespcn", num_frames=3, in_size=8, batch_size=2, reload=False,
                 stage_switch_step=0)
    tr = Trainer(cfg, model=model, device="cpu")
    rng = np.random.default_rng(8)
    batch = {"lr": (rng.random((2, 3, 8, 8, 3)) * 255).astype(np.uint8),
             "gt": (rng.random((2, 1, 32, 32, 3)) * 255).astype(np.uint8)}
    loss = tr.step(batch, tr.step_generator(0))["loss"]
    assert np.isfinite(loss.item())
    assert not torch.equal(model.easyflow.c1.kernel, ef.model.c1.kernel)  # the joint stage moves it
    with pytest.raises(FileNotFoundError):
        restore_easyflow_params(str(tmp_path / "none"), model)
