"""Trainer (counterpart: pfnl_tpu/train/trainer.py:46-355), every family.

Replicates the reference training semantics:
  * Adam (beta1=0.9, beta2=0.999, eps=1e-8) with polynomial lr decay
    driven by the *global* step (tf.train.polynomial_decay,
    model/pfnl.py:156), evaluated at the step before its increment, as
    optax.polynomial_schedule in the JAX trainer (:177-181);
  * staged optimisation for the flow families (`stage_switch_step`): before
    the switch the SR-only loss moves the SR parameters alone (the flow
    nets' stay bitwise unchanged), from the switch on the joint loss moves
    every parameter under a second Adam whose state starts fresh there,
    like the reference's two coexisting AdamOptimizers
    (model/vespcn.py:227-229,253-257; JAX :110-116, :183-185);
  * DRVSR's LSTM-only clip_by_global_norm(3) before Adam, in both stages
    (model/drvsr.py:313-326; JAX :97-108);
  * NaN check + loss>10 collapse break (model/pfnl.py:197-199), at log
    cadence (a per-step readback would wait on the device every step);
  * save + eval every 500 steps, loss print every 20 (model/pfnl.py:180-192);
  * checkpoints (step, parameters, every stage's Adam state) under
    `workdir`, newest 5 kept; reload=True resumes from the newest
    (reference semantics), in either stage.

One step: the uint8 host batch goes to the device, where it is augmented
and degraded (data/pipeline.py), then the model's forward in training mode,
loss, backward (on a CUDA device PFNL's chain runs kernels 5 and 6; the
flow families' splats run kernels 7 and 8 forward and their gather
adjoints backward; DUF's backbone runs cuDNN, or kernel 10 forward with
conv3d_impl="pallas") and the Adam update.  DUF's BatchNorms normalise by
the batch statistics and update their buffers once a step, as JAX's
`mutable=["batch_stats"]` step does; an evaluation inside `fit` runs the
model in eval mode and gives it back in training mode.

Data-parallel training (`fit(mesh=...)`, JAX `Trainer.fit(mesh=)`), one
process per device: the model runs under DistributedDataParallel over the
mesh's data axis (gradients averaged, so DRVSR's LSTM clip applies to the
averaged gradient, as optax clips the global one; `find_unused_parameters`
for the staged families), each rank steps its own rows of the global batch
with the flips the single-process step draws for those rows, DUF's training
BatchNorms take the global batch's statistics (`RefBatchNorm.stats_group`),
the logged loss is the mean over the data axis, and rank 0 alone logs,
evaluates and saves, with a barrier after each save and each evaluation.
A resume reads the checkpoint on rank 0 and broadcasts the model, every
Adam state and the step.  Ranks along the space axis hold the same rows,
so the step is replicated over it.

Checkpoints are torch.save files holding the model's state_dict, DUF's
BatchNorm buffers with it; the JAX package's orbax checkpoints are not read
(`utils/weights.from_flax` seeds the port from JAX parameters).  A DUF
checkpoint written before the zero_debias shadows existed loads with them
seeded from the moving statistics (`with_legacy_bn_shadows`, JAX
`_restore_legacy_bn`).
"""

import glob
import math
import os
import time
from typing import Callable, Optional

import torch
import torch.distributed as dist

from pfnl_tpu_torch.data.pipeline import device_augment_and_degrade
from pfnl_tpu_torch.models import MODEL_REGISTRY
from pfnl_tpu_torch.parallel import multihost
from pfnl_tpu_torch.train.losses import LOSS_REGISTRY
from pfnl_tpu_torch.utils.spans import span

KEEP_CHECKPOINTS = 5
# top-level modules whose parameters are the "flow" stage's (JAX `_label_params`)
FLOW_MODULES = ("easyflow", "flow", "flownet")
LSTM_CLIP_NORM = 3.0  # DRVSR (model/drvsr.py:313-326)
# DUF's zero_debias shadows beside each BatchNorm's moving statistics
BN_SHADOWS = ("biased_mean", "biased_var", "local_step")
LEGACY_LOCAL_STEP = 1e7  # past the BatchNorm warm-up: 1 - 0.999^t is 1 in float32


def is_flow_param(name: str) -> bool:
    return name.split(".", 1)[0] in FLOW_MODULES


def is_lstm_param(name: str) -> bool:
    """Any module on the parameter's path named with "lstm" (JAX `_lstm_mask`)."""
    return any("lstm" in k.lower() for k in name.split("."))


def clip_by_global_norm_(grads, max_norm: float):
    """optax.clip_by_global_norm in place: below max_norm the gradients stay
    as they are, otherwise each becomes g / norm * max_norm (no epsilon, so
    not torch's clip_grad_norm_).  No host sync: the choice is a select."""
    if not grads:
        return
    norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm.to(g.dtype) * max_norm))


def polynomial_schedule(init_value: float, end_value: float, power: float,
                        transition_steps: int) -> Callable[[int], float]:
    """optax.polynomial_schedule: from init_value at step 0 to end_value at
    transition_steps, then constant."""
    def schedule(count: int) -> float:
        if transition_steps <= 0:
            return init_value
        count = min(max(count, 0), transition_steps)
        frac = 1.0 - count / transition_steps
        return (init_value - end_value) * frac ** power + end_value

    return schedule


def checkpoints(workdir: str):
    """The `ckpt_*.pt` files under workdir, oldest first."""
    return sorted(glob.glob(os.path.join(workdir, "ckpt_*.pt")))


def save_checkpoint(workdir: str, state: dict) -> str:
    """Write state ("step", "model", and "optimizers", one Adam state a
    stage, where there is Adam state to resume) as workdir/ckpt_<step>.pt,
    atomically; returns the path."""
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, f"ckpt_{state['step']:09d}.pt")
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def with_legacy_bn_shadows(model, saved: dict) -> dict:
    """`saved` as `model` loads it.  A DUF checkpoint written before the
    zero_debias shadows lacks, for some BatchNorms, exactly their three
    shadow entries (BN_SHADOWS); those are seeded as JAX's
    `_restore_legacy_bn` seeds them: biased_mean and biased_var from the
    moving statistics, local_step 1e7.  Any other missing or unexpected key
    is left for load_state_dict to raise on."""
    want = model.state_dict()
    missing = set(want) - set(saved)
    if not missing or set(saved) - set(want):
        return saved
    bns = {k.rsplit(".", 1)[0] for k in missing}
    if missing != {f"{bn}.{s}" for bn in bns for s in BN_SHADOWS} or not all(
            f"{bn}.{s}" in saved for bn in bns for s in ("moving_mean", "moving_variance")):
        return saved
    out = dict(saved)
    for bn in bns:
        out[f"{bn}.biased_mean"] = saved[f"{bn}.moving_mean"].clone()
        out[f"{bn}.biased_var"] = saved[f"{bn}.moving_variance"].clone()
        out[f"{bn}.local_step"] = torch.full_like(want[f"{bn}.local_step"], LEGACY_LOCAL_STEP)
    return out


def load_newest_checkpoint(workdir: str, model, device):
    """Load the newest checkpoint under workdir into `model` (strictly, but
    for a legacy DUF checkpoint's shadows: `with_legacy_bn_shadows`);
    returns its state dict ("step", "model" and, from training,
    "optimizers"), or None when there is none (the model keeps its weights,
    as JAX's restore keeps the init)."""
    ckpts = checkpoints(workdir)
    if not ckpts:
        return None
    state = torch.load(ckpts[-1], map_location=device, weights_only=True)
    model.load_state_dict(with_legacy_bn_shadows(model, state["model"]))
    return state


def build_model(cfg):
    """The config's model (`MODEL_REGISTRY`, the preset's num_frames and
    scale) with weights random from cfg.seed; compute_dtype "bfloat16" is
    mixed precision (bf16 activations, float32 parameters and Adam state,
    float32 loss-facing outputs), as in the JAX package."""
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    return MODEL_REGISTRY[cfg.model](num_frames=cfg.num_frames, scale=cfg.scale, dtype=dtype,
                                     generator=torch.Generator().manual_seed(cfg.seed))


class Trainer:
    def __init__(self, cfg, workdir: Optional[str] = None, model=None, device="cuda",
                 plain: bool = False):
        """cfg: a pfnl_tpu.config.Config.  device: where the model, the
        batches and the optimizer state live.  plain: run the model's
        plain path under plain autograd (the reference for the kernels)."""
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = (model if model is not None else build_model(cfg)).to(self.device)
        self.plain = plain
        self.loss_fn = LOSS_REGISTRY[cfg.model]
        self.workdir = workdir or cfg.save_dir
        self.schedule = polynomial_schedule(cfg.learning_rate, cfg.end_lr, cfg.decay_power,
                                            int(cfg.decay_step))
        self.staged = cfg.stage_switch_step is not None
        named = list(self.model.named_parameters())
        # one Adam a stage: the SR parameters before the switch, all of them after
        stages = ([[p for n, p in named if not is_flow_param(n)]] if self.staged else [])
        self.optimizers = tuple(torch.optim.Adam(ps, lr=cfg.learning_rate, betas=(0.9, 0.999),
                                                 eps=1e-8)
                                for ps in stages + [[p for _, p in named]])
        self.clipped = [p for n, p in named if is_lstm_param(n)] if cfg.model == "drvsr" else []
        self.global_step = 0
        self._started = False
        self.net = self.model          # what a step runs: the model, or its DDP wrapper
        self.data_group = None         # the mesh's data axis under data-parallel training
        self.data_part = (0, 1)        # (this rank's index, ranks) along the data axis
        n_flow = sum(p.numel() for n, p in named if is_flow_param(n))
        n_all = sum(p.numel() for _, p in named)
        if n_flow:
            print(f"params num of flow: {n_flow}")
            print(f"params num of sr: {n_all - n_flow}")
        print(f"Params num of all: {n_all}")

    @property
    def stage(self) -> int:
        """0 before cfg.stage_switch_step (staged training only), else 1 when
        staged; 0 for single-stage training."""
        return int(self.staged and self.global_step >= self.cfg.stage_switch_step)

    @property
    def optimizer(self) -> torch.optim.Adam:
        """The Adam the next step applies."""
        return self.optimizers[self.stage]

    # --- train step -----------------------------------------------------
    def step_generator(self, step: int) -> torch.Generator:
        """The flips' random stream of global step `step`, on the device
        (the JAX trainer folds the step into its key)."""
        return torch.Generator(device=self.device).manual_seed(((self.cfg.seed + 1) << 32) + step)

    def step(self, batch, generator: torch.Generator):
        """One training step on a uint8 host batch; returns the losses as
        device tensors (reading them waits for the device).  Under the
        spans (utils/spans.py) "train.step", counting the global `step`,
        and "train.upload" around the batch's upload."""
        with span("train.step", step=self.global_step):
            with span("train.upload"):
                batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
            lr_in, gt = device_augment_and_degrade(batch, generator, self.cfg.producer,
                                                   self.cfg.scale, part=self.data_part)
            self.model.train()
            out = self.net(lr_in, plain=self.plain)
            losses = self.loss_fn(out if isinstance(out, dict) else {"sr": out}, gt, lr_in)
            # every gradient is cleared: the SR stage's Adam leaves the flow's unread
            self.model.zero_grad(set_to_none=True)
            losses["loss_sr" if self.staged and self.stage == 0 else "loss"].backward()
            self.apply_gradients()
            return {k: v.detach() for k, v in losses.items()}

    def apply_gradients(self):
        """The stage's Adam on the parameters' .grad (DRVSR's LSTM gradients
        clipped first) at the learning rate of the global step before its
        increment."""
        optimizer = self.optimizer
        clip_by_global_norm_([p.grad for p in self.clipped if p.grad is not None],
                             LSTM_CLIP_NORM)
        lr_now = self.schedule(self.global_step)
        for group in optimizer.param_groups:
            group["lr"] = lr_now
        optimizer.step()
        self.global_step += 1

    # --- checkpointing --------------------------------------------------
    def checkpoints(self):
        return checkpoints(self.workdir)

    def save(self):
        save_checkpoint(self.workdir, {"step": self.global_step, "model": self.model.state_dict(),
                                       "optimizers": [o.state_dict() for o in self.optimizers]})
        for old in self.checkpoints()[:-KEEP_CHECKPOINTS]:
            os.remove(old)

    def restore(self) -> bool:
        """Load the newest checkpoint, if there is one (reference reload=True),
        with every stage's Adam state.  One without Adam state (`import-tf1`
        writes the model alone, at step 0) starts each Adam fresh, as JAX's
        import writes a fresh optimizer state.  Under a process group rank 0
        reads it and every rank loads rank 0's (only rank 0 saves)."""
        state = None
        if multihost.is_main():
            state = load_newest_checkpoint(self.workdir, self.model, self.device)
        state = multihost.broadcast_from_main(state)
        if state is None:
            return False
        if not multihost.is_main():
            self.model.load_state_dict(with_legacy_bn_shadows(self.model, state["model"]))
        saved = state.get("optimizers", [])
        if saved and len(saved) != len(self.optimizers):
            raise ValueError(f"{self.workdir}: the checkpoint holds {len(saved)} Adam states, "
                             f"this configuration trains in {len(self.optimizers)} stages")
        for optimizer, opt_state in zip(self.optimizers, saved):
            optimizer.load_state_dict(opt_state)
        self.global_step = int(state["step"])
        return True

    # --- data parallelism -----------------------------------------------
    def distribute(self, mesh):
        """Run the steps under DistributedDataParallel over `mesh`'s data
        axis (parallel/mesh.py), this process's rank driving self.device;
        the pipeline gives this rank its rows of the global batch
        (`multihost.local_batch_size`)."""
        from torch.nn.parallel import DistributedDataParallel

        from pfnl_tpu_torch.parallel.mesh import data_group

        group = data_group(mesh)
        size = dist.get_world_size(group)
        self.data_group = group
        self.data_part = (dist.get_rank(group), size)
        for m in self.model.modules():
            if hasattr(m, "stats_group"):
                m.stats_group = group if size > 1 else None
        self.net = DistributedDataParallel(
            self.model, device_ids=[self.device] if self.device.type == "cuda" else None,
            process_group=group, find_unused_parameters=self.staged)

    def _mean_over_data(self, v: torch.Tensor) -> float:
        """A rank's loss -> its mean over the data axis (every rank calls it)."""
        if self.data_group is None:
            return float(v)
        v = v.detach().float().clone()
        dist.all_reduce(v, group=self.data_group)
        return float(v) / self.data_part[1]

    # --- loop -----------------------------------------------------------
    def fit(self, pipeline, max_steps: Optional[int] = None,
            eval_fn: Optional[Callable[["Trainer", int], None]] = None,
            save_every: int = 500, log_every: int = 20, print_fn=print,
            mesh=None) -> "Trainer":
        """Train until global step max_steps (cfg.max_step by default);
        eval_fn(trainer, step) runs every save_every steps.  mesh: train
        data-parallel over it (`distribute`), every rank calling fit."""
        cfg = self.cfg
        if mesh is not None and self.data_group is None:
            self.distribute(mesh)
        main = multihost.is_main()
        if not main:
            print_fn = lambda *a, **k: None  # noqa: E731  (rank 0 alone logs)
        if cfg.reload and not self._started:
            self.restore()
        self._started = True
        max_steps = max_steps or cfg.max_step
        start = self.global_step
        t0 = time.time()
        last_losses = None

        def check(step) -> bool:
            """Divergence check on the most recent loss (model/pfnl.py:195-199)."""
            if last_losses is None:
                return True
            loss_v = self._mean_over_data(last_losses["loss"])
            if math.isnan(loss_v):
                raise FloatingPointError("Model diverged with loss = NaN")
            if step > 500 and loss_v > 10:
                print_fn(f"Model collapsed with loss={loss_v}")
                return False
            return True

        collapsed = False
        for step in range(start, max_steps):
            if step > start and step % log_every == 0:
                if not check(step):
                    collapsed = True
                    break
                print_fn(f"{time.strftime('%Y-%m-%d %H:%M:%S')} Step:{step},"
                         f" loss:{self._mean_over_data(last_losses['loss'])}")
            if step % save_every == 0:
                if step > start:
                    if main:
                        self.save()
                    multihost.barrier()
                if eval_fn is not None:
                    if main:
                        eval_fn(self, step)
                    multihost.barrier()
                print_fn(f"cost {time.time() - t0}s.")
                t0 = time.time()
            last_losses = self.step(pipeline.get_batch(), self.step_generator(step))
        if not collapsed:
            check(max_steps)
        return self
