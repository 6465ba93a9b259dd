"""Worker of tests/test_torch_parallel.py: one rank of a gloo process group
on the CPU, started by `torch.multiprocessing.spawn`.  The test writes the
inputs (`inputs.pt`: weights, batches, attention inputs) into a directory;
every rank runs every task on them and rank r writes its results to
`rank{r}.pt`, which the test holds against one process (and the JAX
package).  One spawn serves every check, since starting the processes is
the costly part.

Tasks: the mesh's shapes and groups; `nonlocal_attention_sp` (dense and
chunked) and `local_block`'s refusal; one DDP step of a tiny PFNL; one DDP
step of DUF-16L (output, gradients, BatchNorm buffers: the global
statistics; and with each rank's own statistics); VESPCN across its stage
switch under DDP; a save on rank 0 only and a resume that broadcasts the
model, the Adam state and the step.
"""

import os

import torch

torch.set_num_threads(1)


def _pfnl_step(inp, mesh, workdir):
    from pfnl_tpu_torch.config import preset
    from pfnl_tpu_torch.models.pfnl import PFNL
    from pfnl_tpu_torch.train.trainer import Trainer

    cfg = preset("pfnl", **inp["pfnl_cfg"])
    model = PFNL(num_frames=cfg.num_frames, num_blocks=inp["pfnl_blocks"])
    model.load_state_dict(inp["pfnl_weights"])
    tr = Trainer(cfg, workdir=workdir, model=model, device="cpu")
    tr.distribute(mesh)
    loss = tr.step(_rows(inp["pfnl_batch"], mesh), tr.step_generator(0))["loss"]
    return {"loss": tr._mean_over_data(loss),
            "params": {k: v.detach().clone() for k, v in tr.model.state_dict().items()}}


def _rows(batch, mesh):
    """This rank's rows of a global host batch (its data index's part)."""
    from pfnl_tpu_torch.parallel.mesh import data_group

    group = data_group(mesh)
    i, n = torch.distributed.get_rank(group), torch.distributed.get_world_size(group)
    return {k: v[i * (len(v) // n):(i + 1) * (len(v) // n)] for k, v in batch.items()}


def _duf_step(inp, mesh, workdir, global_stats=True):
    """One DDP step of DUF-16L; global_stats=False takes each rank's own
    BatchNorm statistics instead (what the global ones repair)."""
    from pfnl_tpu_torch.config import preset
    from pfnl_tpu_torch.models import DUF
    from pfnl_tpu_torch.train.trainer import Trainer

    cfg = preset("duf", **inp["duf_cfg"])
    model = DUF(layers=16)
    model.load_state_dict(inp["duf_weights"])
    tr = Trainer(cfg, workdir=workdir, model=model, device="cpu")
    tr.distribute(mesh)
    if not global_stats:
        for m in model.modules():
            if hasattr(m, "stats_group"):
                m.stats_group = None
    batch = _rows(inp["duf_batch"], mesh)
    outs = []
    handle = tr.model.register_forward_hook(lambda m, a, out: outs.append(out.detach().clone()))
    tr.step(batch, tr.step_generator(0))
    handle.remove()
    return {"sr": outs[0],
            "grads": {k: p.grad.clone() for k, p in tr.model.named_parameters()},
            "state": {k: v.detach().clone() for k, v in tr.model.state_dict().items()}}


def _vespcn_steps(inp, mesh, workdir):
    from pfnl_tpu_torch.config import preset
    from pfnl_tpu_torch.models import VESPCN
    from pfnl_tpu_torch.train.trainer import Trainer

    cfg = preset("vespcn", **inp["vespcn_cfg"])
    model = VESPCN(num_frames=cfg.num_frames)
    model.load_state_dict(inp["vespcn_weights"])
    tr = Trainer(cfg, workdir=workdir, model=model, device="cpu")
    tr.distribute(mesh)
    for step, batch in enumerate(inp["vespcn_batches"]):
        tr.step(_rows(batch, mesh), tr.step_generator(step))
    return {"params": {k: v.detach().clone() for k, v in tr.model.state_dict().items()},
            "stage": tr.stage}


class _Batches:
    """A pipeline of fixed host batches (this rank's rows)."""

    def __init__(self, batches, mesh):
        self.batches, self.mesh, self.i = batches, mesh, 0

    def get_batch(self):
        b = self.batches[self.i % len(self.batches)]
        self.i += 1
        return _rows(b, self.mesh)


def _save_and_resume(inp, mesh, workdir):
    """fit 3 steps saving at step 2 (rank 0 only), then a fresh Trainer on
    every rank resumes from step 2 (rank 0 reads, broadcasts) and fits to
    step 3 on the same batch."""
    from pfnl_tpu_torch.config import preset
    from pfnl_tpu_torch.models.pfnl import PFNL
    from pfnl_tpu_torch.train.trainer import Trainer

    cfg = preset("pfnl", **inp["pfnl_cfg"])
    batches = inp["resume_batches"]
    first = PFNL(num_frames=cfg.num_frames, num_blocks=inp["pfnl_blocks"])
    first.load_state_dict(inp["pfnl_weights"])
    tr = Trainer(cfg, workdir=workdir, model=first, device="cpu")
    log = []
    tr.fit(_Batches(batches, mesh), max_steps=3, save_every=2, log_every=1, mesh=mesh,
           print_fn=log.append)
    saved = sorted(os.listdir(workdir))
    # a fresh model on rank 1 (other weights), resuming from rank 0's checkpoint at step 2
    fresh = PFNL(num_frames=cfg.num_frames, num_blocks=inp["pfnl_blocks"],
                 generator=torch.Generator().manual_seed(1 + torch.distributed.get_rank()))
    tr2 = Trainer(preset("pfnl", **dict(inp["pfnl_cfg"], reload=True)), workdir=workdir,
                  model=fresh, device="cpu")
    tr2.fit(_Batches(batches[2:], mesh), max_steps=3, save_every=10 ** 9, log_every=1, mesh=mesh,
            print_fn=log.append)
    adam = tr2.optimizers[0].state_dict()["state"]
    return {"saved": saved, "log": log,
            "continued": {k: v.detach().clone() for k, v in tr.model.state_dict().items()},
            "resumed": {k: v.detach().clone() for k, v in tr2.model.state_dict().items()},
            "resumed_step": tr2.global_step,
            "adam_steps": sorted({float(s["step"]) for s in adam.values()})}


def run(rank, world, address, directory):
    import torch.distributed as dist

    from pfnl_tpu_torch.parallel import multihost
    from pfnl_tpu_torch.parallel.mesh import data_group, make_mesh, space_group
    from pfnl_tpu_torch.parallel.nonlocal_sp import local_block, nonlocal_attention_sp

    multihost.initialize(address, world, rank, device="cpu")
    inp = torch.load(os.path.join(directory, "inputs.pt"), weights_only=False)
    out = {"world": multihost.world_size(), "rank": multihost.rank()}
    try:
        meshes = {}
        for dims in ((world, 1), (1, world)):
            m = make_mesh(*dims)
            meshes[dims] = m
            out[f"mesh{dims}"] = (tuple(m.shape), dist.get_world_size(data_group(m)),
                                  dist.get_world_size(space_group(m)))
        try:
            make_mesh(world + 1, 1)
        except ValueError:
            out["mesh_refused"] = True
        space = space_group(meshes[(1, world)])
        th, ph, g = inp["attn"]
        for impl in ("dense", "chunked"):
            out[f"sp_{impl}"] = nonlocal_attention_sp(
                local_block(th, space), local_block(ph, space), local_block(g, space), space,
                impl=impl)
        try:
            local_block(th[:, :th.shape[1] - 1], space)
        except ValueError:
            out["block_refused"] = True
        dp = meshes[(world, 1)]
        out["pfnl"] = _pfnl_step(inp, dp, os.path.join(directory, "pfnl"))
        out["duf"] = _duf_step(inp, dp, os.path.join(directory, "duf"))
        out["duf_local"] = _duf_step(inp, dp, os.path.join(directory, "duf"), global_stats=False)
        out["vespcn"] = _vespcn_steps(inp, dp, os.path.join(directory, "vespcn"))
        out["resume"] = _save_and_resume(inp, dp, os.path.join(directory, "resume"))
    finally:
        torch.save(out, os.path.join(directory, f"rank{rank}.pt"))
        dist.destroy_process_group()
