"""The port's multi-device paths (pfnl_tpu_torch/parallel/, the data-parallel
Predictor, DDP training, `train --dp`, `test --dp`) on the CPU, against one
process and against the JAX package's mesh paths (tests/test_parallel.py,
tests/test_multihost.py) on the same numpy-seeded inputs.

The multi-rank checks run in ONE spawn of two gloo processes
(tests/torch_dist_worker.py, the module fixture `ranks`): starting processes
is the costly part.  Tolerances: attention 1e-5 (float32, the same formula
in another summation order); a DDP step of PFNL 5e-5 on the parameters
(tests/test_parallel.py:70: the sharded gradient all-reduce sums in another
order, and Adam's first step normalises each element); DUF-16L's BatchNorm
buffers 1e-6 of their norms, its output and gradients 1e-6 or 3x what
float32 alone moves them, whichever is larger (the one-process step with
the batch's rows swapped: the output by about 1.3e-6, the gradients by up to
1e-5 of their norms; the biases a BatchNorm cancels, 0 in exact arithmetic,
within 1e-9), where each rank's own statistics miss by 1e-2 and more; the
Predictor's frames within 1 uint8 step of JAX's and equal to the
single-device port's."""

import glob
import os
import socket

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.multiprocessing as mp

torch.set_num_threads(2)

from pfnl_tpu.config import preset as j_preset
from pfnl_tpu.infer.predictor import Predictor as JPredictor
from pfnl_tpu.models.pfnl import PFNL as JPFNL
from pfnl_tpu.models.vespcn import VESPCN as JVESPCN
from pfnl_tpu.ops.nonlocal_attn import nonlocal_attention as j_nonlocal_attention
from pfnl_tpu.parallel.mesh import make_mesh as j_make_mesh, replicate, shard_batch
from pfnl_tpu.parallel.nonlocal_sp import nonlocal_attention_sp as j_nonlocal_attention_sp
from pfnl_tpu.train.trainer import Trainer as JTrainer

from pfnl_tpu_torch.__main__ import main
from pfnl_tpu_torch.config import preset
from pfnl_tpu_torch.data.pipeline import device_augment_and_degrade
from pfnl_tpu_torch.infer.predictor import Predictor
from pfnl_tpu_torch.models import DUF, VESPCN
from pfnl_tpu_torch.models.duf import bn_cancelled_bias
from pfnl_tpu_torch.models.pfnl import PFNL
from pfnl_tpu_torch.ops.nonlocal_attn import nonlocal_attention
from pfnl_tpu_torch.parallel import multihost
from pfnl_tpu_torch.parallel.spmd import sharded_apply_dp, sharded_forward_dp
from pfnl_tpu_torch.train.trainer import Trainer
from pfnl_tpu_torch.utils.image_io import imread
from pfnl_tpu_torch.utils.weights import from_flax
from tests import torch_dist_worker
from tests.util_data import make_dataset

WORLD = 2
LR = 8
PFNL_CFG = dict(num_frames=3, in_size=LR, batch_size=8, producer="double", reload=False)
DUF_CFG = dict(in_size=LR, batch_size=2, reload=False)
VESPCN_CFG = dict(in_size=LR, batch_size=2, stage_switch_step=1, reload=False)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _double(rng, b, t):
    return {"lr": (rng.random((b, t, LR, LR, 3)) * 255).astype(np.uint8),
            "gt": (rng.random((b, 1, 4 * LR, 4 * LR, 3)) * 255).astype(np.uint8)}


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """The JAX PFNL step's state and batch, and every input of the worker."""
    rng = np.random.default_rng(0)
    attn = [rng.standard_normal((2, 64, 16)).astype(np.float32) for _ in range(3)]
    batch = _double(rng, 8, 3)
    jtr = JTrainer(j_preset("pfnl", **PFNL_CFG), workdir=str(tmp_path_factory.mktemp("jax_dp")),
                   model=JPFNL(num_frames=3, num_blocks=1))
    jstate = jtr.init_state(jax.random.PRNGKey(0), batch["lr"].astype(np.float32) / 255)
    pfnl_weights = from_flax(_np(jstate.params))
    duf = DUF(layers=16, generator=torch.Generator().manual_seed(3))
    vespcn = VESPCN(num_frames=3, generator=torch.Generator().manual_seed(4))
    return {
        "jtr": jtr, "jstate": jstate, "attn_np": attn,
        "worker": {
            "attn": [torch.from_numpy(a) for a in attn],
            "pfnl_cfg": PFNL_CFG, "pfnl_blocks": 1, "pfnl_weights": pfnl_weights,
            "pfnl_batch": {k: torch.from_numpy(v) for k, v in batch.items()},
            "duf_cfg": DUF_CFG, "duf_weights": _state(duf),
            "duf_batch": {k: torch.from_numpy(v) for k, v in _double(rng, 2, 7).items()},
            "vespcn_cfg": VESPCN_CFG, "vespcn_weights": _state(vespcn),
            "vespcn_batches": [{k: torch.from_numpy(v) for k, v in _double(rng, 2, 3).items()}
                               for _ in range(3)],
            "resume_batches": [{k: torch.from_numpy(v) for k, v in _double(rng, 2, 3).items()}
                               for _ in range(3)],
        }}


@pytest.fixture(scope="module")
def ranks(inputs, tmp_path_factory):
    """Every worker task on two gloo ranks: [rank 0's results, rank 1's]."""
    d = str(tmp_path_factory.mktemp("torch_dist"))
    torch.save(inputs["worker"], os.path.join(d, "inputs.pt"))
    mp.spawn(torch_dist_worker.run, args=(WORLD, f"localhost:{_free_port()}", d), nprocs=WORLD,
             join=True)
    return [torch.load(os.path.join(d, f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]


def test_make_mesh_shapes(ranks):
    """JAX: tests/test_parallel.py::test_mesh_shapes, on the two ranks there are."""
    for r, res in enumerate(ranks):
        assert (res["world"], res["rank"]) == (WORLD, r)
        assert res[f"mesh{(WORLD, 1)}"] == ((WORLD, 1), WORLD, 1)
        assert res[f"mesh{(1, WORLD)}"] == ((1, WORLD), 1, WORLD)
        assert res["mesh_refused"]  # a mesh of more ranks than the group has


@pytest.mark.parametrize("impl", ["dense", "chunked"])
def test_spatial_attention_matches_dense_and_jax(ranks, inputs, impl):
    """Each rank's query block against every rank's keys and values ==
    dense attention, and JAX's nonlocal_attention_sp over 8 virtual
    devices (1x8 dense, 2x4 chunked, as tests/test_parallel.py)."""
    th, ph, g = inputs["attn_np"]
    got = torch.cat([res[f"sp_{impl}"] for res in ranks], 1).numpy()
    dense = nonlocal_attention(*(torch.from_numpy(a) for a in (th, ph, g))).numpy()
    mesh = j_make_mesh(n_data=1, n_space=8) if impl == "dense" else j_make_mesh(2, 4)
    jax_sp = np.asarray(j_nonlocal_attention_sp(*(jnp.asarray(a) for a in (th, ph, g)), mesh,
                                                impl=impl))
    np.testing.assert_allclose(got, dense, atol=1e-5)
    np.testing.assert_allclose(got, jax_sp, atol=1e-5)
    np.testing.assert_allclose(dense, np.asarray(j_nonlocal_attention(th, ph, g)), atol=1e-5)
    assert all(res["block_refused"] for res in ranks)  # N not divisible by the group


def test_ddp_pfnl_step_matches_one_process_and_jax_8way(ranks, inputs, tmp_path):
    """One DDP step over 2 ranks (4 rows each) == the port's step at the
    global batch of 8 in one process, and JAX's step on an 8-device data
    mesh (tests/test_parallel.py::test_data_parallel_train_step...), from the
    same weights and the same "double" batch (no device randomness)."""
    w = inputs["worker"]
    model = PFNL(num_frames=3, num_blocks=1)
    model.load_state_dict(w["pfnl_weights"])
    tr = Trainer(preset("pfnl", **PFNL_CFG), workdir=str(tmp_path), model=model,
                 device="cpu")
    loss = tr.step(w["pfnl_batch"], tr.step_generator(0))["loss"].item()

    jtr, jstate = inputs["jtr"], inputs["jstate"]
    mesh = j_make_mesh(n_data=8, n_space=1)
    batch = {k: jnp.asarray(v.numpy()) for k, v in w["pfnl_batch"].items()}
    with mesh:
        s2, l2 = jtr.step_fn(0)(replicate(jstate, mesh), shard_batch(batch, mesh),
                                jax.random.PRNGKey(1))
    jax_params = from_flax(_np(jax.device_get(s2.params)))
    for res in ranks:
        assert res["pfnl"]["loss"] == pytest.approx(loss, rel=1e-5)
        assert res["pfnl"]["loss"] == pytest.approx(float(l2["loss"]), rel=1e-5)
        for k, v in model.state_dict().items():
            np.testing.assert_allclose(res["pfnl"]["params"][k].numpy(), v.numpy(), atol=5e-5,
                                       err_msg=k)
            np.testing.assert_allclose(res["pfnl"]["params"][k].numpy(), jax_params[k].numpy(),
                                       atol=5e-5, err_msg=k)


def _duf_single_step(w, batch, workdir):
    """(output, gradients, state after) of one process's DUF-16L step."""
    model = DUF(layers=16)
    model.load_state_dict(w["duf_weights"])
    tr = Trainer(preset("duf", **DUF_CFG), workdir=workdir, model=model,
                 device="cpu")
    outs = []
    model.register_forward_hook(lambda m, a, out: outs.append(out.detach()))
    tr.step(batch, tr.step_generator(0))
    return outs[0], {k: p.grad.clone() for k, p in model.named_parameters()}, _state(model)


def _rel(a, b):
    return ((a - b).norm() / b.norm()).item()


def test_ddp_duf16_takes_the_global_batch_statistics(ranks, inputs, tmp_path):
    """DUF-16L, one row a rank: the output rows, the averaged gradients and
    the five BatchNorm buffers after the step == one process's step at the
    global batch of 2.  With each rank's own statistics (each normalising by
    its own row) the output misses by 1e-2 and more."""
    w = inputs["worker"]
    sr, grads, state = _duf_single_step(w, w["duf_batch"], str(tmp_path / "a"))
    sr_rev, grads_rev, _ = _duf_single_step(w, {k: v.flip(0) for k, v in w["duf_batch"].items()},
                                            str(tmp_path / "b"))
    tol = max(1e-6, 3 * _rel(sr_rev.flip(0), sr))
    assert _rel(torch.cat([res["duf"]["sr"] for res in ranks]), sr) <= tol
    assert _rel(torch.cat([res["duf_local"]["sr"] for res in ranks]), sr) > 1e-2
    buffers = {k: v for k, v in state.items()
               if k.rsplit(".", 1)[1] in ("moving_mean", "moving_variance", "biased_mean",
                                          "biased_var", "local_step")}
    assert len(buffers) == 5 * sum(1 for k in buffers if k.endswith("local_step")) > 0
    for res in ranks:
        for k, g in grads.items():
            err = (res["duf"]["grads"][k] - g).norm().item()
            if bn_cancelled_bias(k):
                assert err <= 1e-9, k
            else:
                floor = (grads_rev[k] - g).norm().item()
                assert err <= max(1e-6 * g.norm().item(), 3 * floor), (k, err, floor)
        for k, v in buffers.items():
            got = res["duf"]["state"][k]
            assert (got - v).norm().item() <= 1e-6 * max(v.norm().item(), 1e-30), k


def test_ddp_vespcn_across_the_stage_switch(ranks, inputs, tmp_path):
    """VESPCN staged at step 1 (the flow net gets gradients but no update
    before it): three DDP steps == three steps at the global batch."""
    w = inputs["worker"]
    model = VESPCN(num_frames=3)
    model.load_state_dict(w["vespcn_weights"])
    tr = Trainer(preset("vespcn", **VESPCN_CFG), workdir=str(tmp_path), model=model,
                 device="cpu")
    for step, batch in enumerate(w["vespcn_batches"]):
        tr.step(batch, tr.step_generator(step))
    for res in ranks:
        assert res["vespcn"]["stage"] == tr.stage == 1
        for k, v in model.state_dict().items():
            np.testing.assert_allclose(res["vespcn"]["params"][k].numpy(), v.numpy(),
                                       atol=5e-5, err_msg=k)


def test_save_on_rank_0_and_resume_broadcasts_model_adam_and_step(ranks):
    """Only rank 0 writes the step-2 checkpoint and logs; a resume on every
    rank (rank 1 from other weights) takes rank 0's model, Adam state and
    step, and its step 3 equals the uninterrupted run's."""
    for r, res in enumerate(ranks):
        out = res["resume"]
        assert out["saved"] == ["ckpt_000000002.pt"]
        assert bool(out["log"]) == (r == 0)
        assert out["resumed_step"] == 3 and out["adam_steps"] == [3.0]
        for k, v in ranks[0]["resume"]["continued"].items():
            np.testing.assert_allclose(out["resumed"][k].numpy(), v.numpy(), atol=1e-6,
                                       err_msg=k)
            np.testing.assert_array_equal(out["continued"][k].numpy(), v.numpy(), err_msg=k)


def test_flips_of_the_parts_are_the_global_batchs():
    """device_augment_and_degrade with part (i, n) flips the rows that the
    global batch's draw flips."""
    gt = torch.from_numpy((np.random.default_rng(5).random((4, 3, 16, 16, 3)) * 255)
                          .astype(np.uint8))
    whole = device_augment_and_degrade({"gt": gt}, torch.Generator().manual_seed(7), "single", 4)
    parts = [device_augment_and_degrade({"gt": gt[2 * i:2 * i + 2]},
                                        torch.Generator().manual_seed(7), "single", 4,
                                        part=(i, 2)) for i in range(2)]
    for got, want in zip((torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])),
                         whole):
        assert torch.equal(got, want)


def test_sharded_forward_dp_splits_rows_and_refuses_an_uneven_batch():
    model = PFNL(num_frames=3, num_blocks=1).eval()
    x = torch.rand(4, 3, 8, 8, 3)
    with torch.no_grad():
        got = sharded_forward_dp(model, ["cpu", "cpu"])(x)
        want = model(x)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="does not split"):
        sharded_apply_dp(lambda d, s: s, ["cpu"] * 3)(x)


@pytest.fixture(scope="module")
def clip_dir(tmp_path_factory):
    _, seq_dirs = make_dataset(str(tmp_path_factory.mktemp("dpclip")), num_seqs=1, num_frames=9,
                               hw=(32, 32))
    return seq_dirs[0]


@pytest.mark.parametrize("name", ["pfnl", "vespcn"])
def test_predictor_on_two_devices_writes_the_same_pngs(clip_dir, name):
    """Predictor(devices=["cpu"] * 2) == the single-device Predictor, and
    within 1 uint8 step of JAX's Predictor(mesh=8 devices)
    (tests/test_parallel.py::test_predictor_mesh_matches_single_chip)."""
    rng = np.random.default_rng(11)
    x = jnp.asarray(rng.random((1, 3, 8, 8, 3)).astype(np.float32))
    jm = JPFNL(num_frames=3, num_blocks=1) if name == "pfnl" else JVESPCN(num_frames=3)
    variables = jm.init(jax.random.PRNGKey(0), x)
    model = (PFNL(num_frames=3, num_blocks=1) if name == "pfnl" else VESPCN(num_frames=3)).eval()
    model.load_state_dict(from_flax(_np(variables["params"])))
    JPredictor(j_preset(name, num_frames=3, reload=False), jm, variables,
               mesh=j_make_mesh(n_data=8, n_space=1)).test_video_lr(clip_dir, name=f"{name}_jax")
    single = Predictor(model)
    multi = Predictor(model, devices=["cpu", "cpu"], batch_windows=3)
    assert multi.batch_windows == 4
    single.test_video_lr(clip_dir, name=f"{name}_one")
    multi.test_video_lr(clip_dir, name=f"{name}_two")
    files = {k: sorted(glob.glob(os.path.join(clip_dir, f"{name}_{k}", "*.png")))
             for k in ("jax", "one", "two")}
    assert len(files["jax"]) == len(files["one"]) == len(files["two"]) == 9
    for j, a, b in zip(files["jax"], files["one"], files["two"]):
        ia, ib = imread(a).astype(np.int32), imread(b).astype(np.int32)
        assert np.array_equal(ia, ib), b
        assert np.max(np.abs(ib - imread(j).astype(np.int32))) <= 1, b


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("dptrain")
    filelist, _ = make_dataset(str(root), num_seqs=4, num_frames=20, hw=(48, 48))
    return filelist


def test_cli_train_dp2_on_the_cpu(dataset, tmp_path, monkeypatch):
    """`train pfnl --dp 2 --device cpu` starts two ranks: 3 steps, rank 0
    alone saves (step 2) and evaluates (steps 0 and 2, once each)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")  # the ranks share these two threads
    save = tmp_path / "ck"
    main(["train", "pfnl", "--train-list", dataset, "--eval-list", dataset, "--steps", "3",
          "--in-size", "8", "--batch-size", "2", "--save-dir", str(save), "--save-every", "2",
          "--eval-in-size", "8x8", "--device", "cpu", "--dp", "2"])
    assert sorted(os.listdir(save)) == ["ckpt_000000002.pt", "pfnl.txt"]
    with open(save / "pfnl.txt") as f:
        iters = [line.split(",")[0].split(":")[1].strip() for line in f if line.strip()]
    assert iters == ["0", "2"]


def test_cli_train_refuses_a_batch_dp_does_not_divide(dataset, tmp_path):
    with pytest.raises(SystemExit, match="batch 3 not divisible by dp=2"):
        main(["train", "pfnl", "--train-list", dataset, "--batch-size", "3", "--dp", "2",
              "--device", "cpu", "--save-dir", str(tmp_path)])


def test_cli_test_dp_refuses_more_gpus_than_visible(tmp_path):
    with pytest.raises(SystemExit, match="GPUs are visible"):
        main(["test", "pfnl", "--data", str(tmp_path), "--dp", str(torch.cuda.device_count() + 2),
              "--save-dir", str(tmp_path)])


def test_initialize_without_a_cluster_is_a_noop(monkeypatch):
    for k in ("RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    multihost.initialize()
    assert not torch.distributed.is_initialized()
    assert (multihost.rank(), multihost.world_size(), multihost.is_main()) == (0, 1, True)
    assert multihost.local_batch_size(16) == 16
    assert multihost.broadcast_from_main({"a": 1}) == {"a": 1}
    with pytest.raises(ValueError):
        multihost.local_batch_size(16, 3)
