"""Standalone EasyFlow pre-training (counterpart:
pfnl_tpu/train/easyflow_trainer.py; reference modules/model_easyflow.py).

Self-supervised: estimate the flow from each Y frame to the clip's centre
frame, backward-warp the centre frame by it, and minimise the photometric
L1 plus 0.01 times the flow's total variation over its size
(model_easyflow.py:108-129).  Adam (0.9, 0.999, 1e-8) with the learning
rate decayed polynomially from `learning_rate` to 1e-6 over 3e5 steps,
power 0.9 (model_easyflow.py:155).

Batches are drawn on the host from `np.random.default_rng(seed)` exactly
as the JAX trainer draws them (a sequence, a first frame, a crop, per
sample), so the same seed and frames give the same crops.  Frames come from
`<seq>/<subdir>/*.png` of the filelist's sequences (`truth/` where there is
no `subdir`), or from in-memory sequences (`sequences=`, read through the
`source=` frame store: MemoryFrames on a machine without a PNG codec).

A checkpoint is `<save_dir>/step_<step>.pt` holding the EasyFlow
state_dict; `restore_easyflow_params` loads the newest into an SR model's
`easyflow` submodule (VESPCN, MCResNet, DRVSR), the analogue of the
reference's load_easyflow (model_easyflow.py:226-240), and the Trainer
then trains that model from it.
"""

import glob
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from pfnl_tpu_torch.data.frames import PngFrames
from pfnl_tpu_torch.models.flows import EasyFlow
from pfnl_tpu_torch.ops.color import rgb2y
from pfnl_tpu_torch.ops.losses import total_variation
from pfnl_tpu_torch.ops.warp import backward_warp_local
from pfnl_tpu_torch.train.trainer import polynomial_schedule


def easyflow_loss(model, frames_y: torch.Tensor):
    """frames_y [B,T,h,w,1] -> (loss, (photometric, tv)): every frame's flow
    to the centre frame, which is warped back to it (|flow| < 2)."""
    b, t, h, w, _ = frames_y.shape
    ref = frames_y[:, t // 2:t // 2 + 1].expand(frames_y.shape)
    flat = frames_y.reshape(b * t, h, w, 1)
    ref_flat = ref.reshape(b * t, h, w, 1)
    uv = model(flat, ref_flat)
    warped = backward_warp_local(ref_flat, uv, max_disp=2)
    loss_data = torch.mean(torch.abs(flat - warped))
    loss_tv = total_variation(uv) / float(uv.numel())
    return loss_data + 0.01 * loss_tv, (loss_data, loss_tv)


class EasyFlowTrainer:
    def __init__(self, train_list: str = "./data/filelist_train.txt",
                 save_dir: str = "./easyflow_log/model1/checkpoints", num_frames: int = 7,
                 crop_size: int = 100, batch_size: int = 20, learning_rate: float = 1e-4,
                 max_steps: int = int(1e6), subdir: str = "input", seed: int = 0,
                 device="cuda", source=None, sequences=None):
        """The JAX trainer's arguments, and: device, where the model (random
        from `seed`, the port's init) and the steps run; source, the frame
        store (PngFrames by default); sequences, lists of frame paths to
        draw from in place of the filelist's."""
        self.device = torch.device(device)
        self.model = EasyFlow(generator=torch.Generator().manual_seed(seed)).to(self.device)
        self.num_frames, self.crop_size, self.batch_size = num_frames, crop_size, batch_size
        self.learning_rate, self.max_steps = learning_rate, max_steps
        self.save_dir, self.train_list, self.subdir, self.seed = save_dir, train_list, subdir, seed
        self.source = source or PngFrames()
        self.sequences = sequences
        self.schedule = polynomial_schedule(learning_rate, 1e-6, 0.9, int(3e5))

    def _sequences(self):
        """Each usable sequence's frame paths: `sequences=` if given, else the
        filelist's `<seq>/<subdir>/*.png` (`truth/` where `subdir` has none)."""
        if self.sequences is not None:
            seqs = [list(s) for s in self.sequences]
        else:
            with open(self.train_list, "rt") as f:
                dirs = [line for line in f.read().splitlines() if line.strip()]
            seqs = [self.source.list(os.path.join(d, self.subdir))
                    or self.source.list(os.path.join(d, "truth")) for d in dirs]
        seqs = [s for s in seqs if len(s) >= self.num_frames]
        if not seqs:
            raise FileNotFoundError(f"no usable sequences in {self.train_list}")
        return seqs

    def sample_batch(self, rng, seqs) -> np.ndarray:
        """[B,T,S,S,3] uint8: per sample a sequence, a first frame and a crop
        drawn from `rng` in the JAX trainer's order."""
        out = []
        for _ in range(self.batch_size):
            files = seqs[rng.integers(len(seqs))]
            t0 = rng.integers(0, len(files) - self.num_frames + 1)
            frames = [self.source.read(files[i]) for i in range(t0, t0 + self.num_frames)]
            h, w = frames[0].shape[:2]
            y0 = rng.integers(0, h - self.crop_size + 1)
            x0 = rng.integers(0, w - self.crop_size + 1)
            out.append(np.stack([f[y0:y0 + self.crop_size, x0:x0 + self.crop_size]
                                 for f in frames]))
        return np.stack(out)

    def step(self, optimizer, step: int, batch_u8: np.ndarray):
        """One Adam step on a uint8 batch at the learning rate of `step`;
        returns (loss, photometric, tv) as device tensors."""
        frames = torch.from_numpy(batch_u8).to(self.device).float() / 255.0
        self.model.train()
        loss, (ld, lt) = easyflow_loss(self.model, rgb2y(frames))
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        for group in optimizer.param_groups:
            group["lr"] = self.schedule(step)
        optimizer.step()
        return loss.detach(), ld.detach(), lt.detach()

    def train(self, max_steps: Optional[int] = None, print_fn=print, save_every: int = 500,
              summary_every: int = 10, image_summary_every: int = 500):
        """Steps 0 .. max_steps-1 from the model's current weights and a fresh
        Adam.  The reference's TensorBoard output as files
        (model_easyflow.py:119-129,173-174,192-195): the scalars every
        `summary_every` steps as lines of <save_dir>/metrics.jsonl, and an
        input / flow / warp PNG of the first sample every
        `image_summary_every` steps under <save_dir>/summaries/ (0: none).
        Returns the model."""
        seqs = self._sequences()
        rng = np.random.default_rng(self.seed)
        optimizer = torch.optim.Adam(self.model.parameters(), lr=self.learning_rate,
                                     betas=(0.9, 0.999), eps=1e-8)
        max_steps = max_steps or self.max_steps
        os.makedirs(self.save_dir, exist_ok=True)
        metrics_path = os.path.join(self.save_dir, "metrics.jsonl")
        for step in range(max_steps):
            batch = self.sample_batch(rng, seqs)
            t0 = time.time()
            loss, ld, lt = self.step(optimizer, step, batch)
            loss = float(loss)
            if np.isnan(loss):
                raise FloatingPointError("Model diverged with loss = NaN")
            dt = time.time() - t0
            if step % 5 == 0:
                print_fn(f"{time.strftime('%Y-%m-%d %H:%M:%S')}: step {step}, "
                         f"loss = {loss * 100:.4f} ({self.batch_size / dt:.1f} data/s)")
            if step % summary_every == 0:
                with open(metrics_path, "at") as f:
                    f.write(json.dumps({
                        "step": step, "loss": loss, "photometric": float(ld), "tv": float(lt),
                        "lr": float(self.schedule(step)),
                        "data_per_sec": self.batch_size / max(dt, 1e-9),
                    }) + "\n")
            if image_summary_every and step % image_summary_every == 0:
                self._image_summaries(batch, step)
            if step % save_every == save_every - 1 or step + 1 == max_steps:
                self.save(step)
        return self.model

    @torch.no_grad()
    def _image_summaries(self, batch_u8, step):
        """The first sample's first frame, the flow from it to the second
        (Middlebury colours) and the second warped back by it, as PNGs."""
        from pfnl_tpu_torch.utils.flow_tools import flow_to_color
        from pfnl_tpu_torch.utils.image_io import imsave

        frames = torch.from_numpy(batch_u8[:1, :2]).to(self.device).float() / 255.0
        y = rgb2y(frames)
        src, ref = y[:, 0], y[:, 1]
        uv = self.model(src, ref)
        warped = backward_warp_local(ref, uv, max_disp=2)
        out_dir = os.path.join(self.save_dir, "summaries")
        os.makedirs(out_dir, exist_ok=True)

        def gray(a):
            img = np.clip(np.round(a[0].cpu().numpy() * 255.0), 0, 255).astype(np.uint8)
            return np.repeat(img, 3, axis=-1)

        imsave(os.path.join(out_dir, f"{step:08d}_input.png"), gray(src))
        imsave(os.path.join(out_dir, f"{step:08d}_warp.png"), gray(warped))
        imsave(os.path.join(out_dir, f"{step:08d}_flow.png"),
               flow_to_color(uv[0].float().cpu().numpy()))

    def save(self, step: int) -> str:
        """The EasyFlow state_dict as <save_dir>/step_<step>.pt, atomically."""
        os.makedirs(self.save_dir, exist_ok=True)
        path = os.path.join(self.save_dir, f"step_{step:08d}.pt")
        torch.save({"step": step, "model": self.model.state_dict()}, path + ".tmp")
        os.replace(path + ".tmp", path)
        return path


def restore_easyflow_params(save_dir: str, model):
    """Load the newest EasyFlow checkpoint under save_dir into the SR model's
    `easyflow` submodule (strictly: a tree that does not fit raises);
    returns the model (the load_easyflow analogue)."""
    ckpts = sorted(glob.glob(os.path.join(save_dir, "step_*.pt")))
    if not ckpts:
        raise FileNotFoundError(f"no EasyFlow checkpoints under {save_dir}")
    device = next(model.easyflow.parameters()).device
    state = torch.load(ckpts[-1], map_location=device, weights_only=True)
    model.easyflow.load_state_dict(state["model"])
    return model
