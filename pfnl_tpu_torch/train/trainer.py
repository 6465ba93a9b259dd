"""Trainer (counterpart: pfnl_tpu/train/trainer.py:78-355), PFNL family.

Replicates the reference training semantics:
  * Adam (beta1=0.9, beta2=0.999, eps=1e-8) with polynomial lr decay
    driven by the *global* step (tf.train.polynomial_decay,
    model/pfnl.py:156), evaluated at the step before its increment, as
    optax.polynomial_schedule in the JAX trainer (:177-181);
  * NaN check + loss>10 collapse break (model/pfnl.py:197-199), at log
    cadence (a per-step readback would wait on the device every step);
  * save + eval every 500 steps, loss print every 20 (model/pfnl.py:180-192);
  * checkpoints (step, parameters, Adam state) under `workdir`, newest 5
    kept; reload=True resumes from the newest (reference semantics).

One step: the uint8 host batch goes to the device, where it is augmented
and degraded (data/pipeline.py), then forward, Charbonnier loss, backward
(kernels 5 and 6 on a CUDA device) and the Adam update.

Not here yet, each raising: staged optimisation (`stage_switch_step`, the
flow families), DRVSR's LSTM-only gradient clipping, DUF's BatchNorm
statistics.  Checkpoints are torch.save files; the JAX package's orbax
checkpoints are not read (`utils/weights.from_flax` seeds the port from
JAX parameters).
"""

import glob
import math
import os
import time
from typing import Callable, Optional

import torch

from pfnl_tpu_torch.data.pipeline import device_augment_and_degrade
from pfnl_tpu_torch.models.pfnl import PFNL
from pfnl_tpu_torch.train.losses import LOSS_REGISTRY

KEEP_CHECKPOINTS = 5


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
    """Write state ("step", "model", and "optimizer" where there is Adam
    state to resume) as workdir/ckpt_<step>.pt, atomically; returns the path."""
    os.makedirs(workdir, exist_ok=True)
    path = os.path.join(workdir, f"ckpt_{state['step']:09d}.pt")
    torch.save(state, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def load_newest_checkpoint(workdir: str, model, device):
    """Load the newest checkpoint under workdir into `model`; returns its
    state dict ("step", "model" and, from training, "optimizer"), or None
    when there is none (the model keeps its weights, as JAX's restore keeps
    the init)."""
    ckpts = checkpoints(workdir)
    if not ckpts:
        return None
    state = torch.load(ckpts[-1], map_location=device, weights_only=True)
    model.load_state_dict(state["model"])
    return state


def build_model(cfg) -> PFNL:
    """The config's model with seeded random weights; compute_dtype
    "bfloat16" is mixed precision (bf16 activations, float32 parameters and
    Adam state, float32 output), as in the JAX package."""
    dtype = torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32
    return PFNL(num_frames=cfg.num_frames, scale=cfg.scale, dtype=dtype,
                generator=torch.Generator().manual_seed(cfg.seed))


class Trainer:
    def __init__(self, cfg, workdir: Optional[str] = None, model=None, device="cuda",
                 plain: bool = False):
        """cfg: a pfnl_tpu.config.Config.  device: where the model, the
        batches and the optimizer state live.  plain: run the model's
        plain path under plain autograd (the reference for the kernels)."""
        if cfg.model == "drvsr":
            raise NotImplementedError("DRVSR's LSTM-only gradient clipping comes with its family")
        if cfg.model == "duf":
            raise NotImplementedError("DUF's BatchNorm statistics come with its family")
        if cfg.model != "pfnl":
            raise NotImplementedError(f"training {cfg.model!r} is not ported: PFNL only")
        if cfg.stage_switch_step is not None:
            raise NotImplementedError("staged optimisation comes with the flow families")
        self.cfg = cfg
        self.device = torch.device(device)
        self.model = (model if model is not None else build_model(cfg)).to(self.device)
        self.plain = plain
        self.loss_fn = LOSS_REGISTRY[cfg.model]
        self.workdir = workdir or cfg.save_dir
        self.schedule = polynomial_schedule(cfg.learning_rate, cfg.end_lr, cfg.decay_power,
                                            int(cfg.decay_step))
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=cfg.learning_rate,
                                          betas=(0.9, 0.999), eps=1e-8)
        self.global_step = 0
        self._started = False
        print(f"Params num of all: {sum(p.numel() for p in self.model.parameters())}")

    # --- train step -----------------------------------------------------
    def step_generator(self, step: int) -> torch.Generator:
        """The flips' random stream of global step `step`, on the device
        (the JAX trainer folds the step into its key)."""
        return torch.Generator(device=self.device).manual_seed(((self.cfg.seed + 1) << 32) + step)

    def step(self, batch, generator: torch.Generator):
        """One training step on a uint8 host batch; returns the losses as
        device tensors (reading them waits for the device)."""
        batch = {k: torch.as_tensor(v).to(self.device) for k, v in batch.items()}
        lr_in, gt = device_augment_and_degrade(batch, generator, self.cfg.producer,
                                               self.cfg.scale)
        losses = self.loss_fn({"sr": self.model(lr_in, plain=self.plain)}, gt, lr_in)
        self.optimizer.zero_grad(set_to_none=True)
        losses["loss"].backward()
        self.apply_gradients()
        return {k: v.detach() for k, v in losses.items()}

    def apply_gradients(self):
        """Adam on the parameters' .grad at the learning rate of the global
        step before its increment."""
        lr_now = self.schedule(self.global_step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr_now
        self.optimizer.step()
        self.global_step += 1

    # --- checkpointing --------------------------------------------------
    def checkpoints(self):
        return checkpoints(self.workdir)

    def save(self):
        save_checkpoint(self.workdir, {"step": self.global_step, "model": self.model.state_dict(),
                                       "optimizer": self.optimizer.state_dict()})
        for old in self.checkpoints()[:-KEEP_CHECKPOINTS]:
            os.remove(old)

    def restore(self) -> bool:
        """Load the newest checkpoint, if there is one (reference reload=True).
        One without Adam state (`import-tf1` writes the model alone, at step
        0) starts Adam fresh, as JAX's import writes a fresh optimizer state."""
        state = load_newest_checkpoint(self.workdir, self.model, self.device)
        if state is None:
            return False
        if "optimizer" in state:
            self.optimizer.load_state_dict(state["optimizer"])
        self.global_step = int(state["step"])
        return True

    # --- loop -----------------------------------------------------------
    def fit(self, pipeline, max_steps: Optional[int] = None,
            eval_fn: Optional[Callable[["Trainer", int], None]] = None,
            save_every: int = 500, log_every: int = 20, print_fn=print) -> "Trainer":
        """Train until global step max_steps (cfg.max_step by default);
        eval_fn(trainer, step) runs every save_every steps."""
        cfg = self.cfg
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
            loss_v = float(last_losses["loss"])
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
                         f" loss:{float(last_losses['loss'])}")
            if step % save_every == 0:
                if step > start:
                    self.save()
                if eval_fn is not None:
                    eval_fn(self, step)
                print_fn(f"cost {time.time() - t0}s.")
                t0 = time.time()
            last_losses = self.step(pipeline.get_batch(), self.step_generator(step))
        if not collapsed:
            check(max_steps)
        return self
