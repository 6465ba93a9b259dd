"""Periodic validation (counterpart: pfnl_tpu/eval/evaluator.py), each
reference family's eval():

  * window centres at frame 15, 47, 79, ... (stride 32);
  * T-frame windows edge-clamped at sequence boundaries;
  * GT cropped [border : out_h+border] with border=8, LR by border // scale;
  * batches of eval_batch_size; LEFTOVER windows that don't fill a batch
    are dropped (reference quirk, model/pfnl.py:127);
  * PSNR = 10*log10(1/mse) on the family's mse definition;
  * appends the reference's JSON-ish log line, with its 1e-6 (PFNL-family)
    or 1e-8 (VESPCN-family) truncation.

Families (`_FAMILY`):
  pfnl    GT-only: degrade on the device, RGB mse vs the centre GT
          (reference model/pfnl.py:94-149)
  vespcn  blur4/ windows + centre GT: Y mse and SSIM per output frame
          (vespcn.py:132-210; SSIM against the GT's Y, as the JAX package
          does, where the reference takes its R channel); DRVSR's full
          forward gives T output frames
  frvsr   10-frame windows idx0-5..idx0+4 (frvsr.py:179), GT for every
          frame, RGB mse per frame
  duf     blur4/ windows + centre GT, RGB mse, in eval mode (dufvsr.py:70-131)

The forward runs under torch.inference_mode() with the model in eval mode,
so on a CUDA device it runs the family's kernels (PFNL at eval_in_size
128x240, 7680 non-local positions: kernel 1 too).
"""

import os
from typing import Callable, List, Optional

import numpy as np
import torch

from pfnl_tpu_torch.data.frames import PngFrames
from pfnl_tpu_torch.data.manifest import load_manifest
from pfnl_tpu_torch.eval.metrics import compute_ssim_batch, psnr_from_mse
from pfnl_tpu_torch.ops.color import rgb2y
from pfnl_tpu_torch.ops.degrade import downsample

_FAMILY = {
    "pfnl": "pfnl",
    "vespcn": "vespcn",
    "mcresnet": "vespcn",
    "ltdvsr": "vespcn",
    "drvsr": "vespcn",
    "frvsr": "frvsr",
    "duf": "duf",
}


def _clipped_window(idx0: int, radius: int, max_frame: int, length: int) -> List[int]:
    idx = np.arange(idx0 - radius, idx0 - radius + length)
    return np.clip(idx, 0, max_frame - 1).tolist()


def _truncated(x: np.ndarray, q: float) -> list:
    return ((x * q).astype(np.int64) / q).tolist()


class Evaluator:
    def __init__(self, cfg, model, center: int = 15, stride: int = 32, border: int = 8,
                 source=None, sequences=None):
        """model: the cfg.model family's model, on its device.  source: the
        frame store the sequences' paths are read from (PngFrames by
        default).  sequences: what to evaluate (data/manifest.Sequence;
        by default cfg.eval_list's, with blur{scale}/ for all but PFNL)."""
        self.cfg = cfg
        self.model = model
        self.family = _FAMILY[cfg.model]
        self.center = center
        self.stride = stride
        self.border = border
        in_h, in_w = cfg.eval_in_size
        self.in_hw = (in_h, in_w)
        self.out_hw = (in_h * cfg.scale, in_w * cfg.scale)
        self.source = source or PngFrames()
        self.sequences = sequences or load_manifest(cfg.eval_list, cfg.scale,
                                                    need_blur=self.family != "pfnl")

    def _read(self, path, y: int, x: int, hw) -> np.ndarray:
        return self.source.read(path)[y:y + hw[0], x:x + hw[1]].astype(np.float32) / 255.0

    def _windows(self):
        """Yield each window's (LR frames [T,h,w,3] or None for PFNL, GT
        frames [Tg,H,W,3]), float32."""
        t = self.cfg.num_frames
        b, bd = self.border, self.border // self.cfg.scale
        for seq in self.sequences:
            max_frame = len(seq.truth)
            for idx0 in range(self.center, max_frame, self.stride):
                # frvsr: no +1 quirk, since its window has an even length
                index = _clipped_window(idx0, t // 2, max_frame, t)
                gt_idx = [idx0] if self.family in ("vespcn", "duf") else index
                gt = np.stack([self._read(seq.truth[i], b, b, self.out_hw) for i in gt_idx])
                if self.family == "pfnl":
                    yield None, gt
                else:
                    yield np.stack([self._read(seq.blur[i], bd, bd, self.in_hw)
                                    for i in index]), gt

    def _batch(self, lr, gt):
        """One batch on the device -> (mse [B,T'], ssim [B,T'] or None)."""
        if self.family == "pfnl":
            t = self.cfg.num_frames
            sr = self.model(downsample(gt, scale=self.cfg.scale))
            gt = gt[:, t // 2:t // 2 + 1]
        else:
            out = self.model(lr)
            sr = out["sr"] if isinstance(out, dict) else out
        if self.family != "vespcn":
            return ((sr - gt) ** 2).mean(dim=(2, 3, 4)), None
        gt_y = rgb2y(gt)
        mse = ((sr - gt_y) ** 2).mean(dim=(2, 3, 4))
        ssim = compute_ssim_batch(sr[..., 0], gt_y[:, :, :, :, 0].expand(sr.shape[:-1]), l=1.0)
        return mse, ssim

    def run(self, step: int, log_path: Optional[str] = None, print_fn: Callable = print):
        """Returns (psnr_avg, mse_avg), and for the VESPCN family also
        ssim_avg, each over the output frames ([1] for PFNL and DUF)."""
        cfg = self.cfg
        device = next(self.model.parameters()).device
        mse_acc, ssim_acc, batch, cnt = [], [], [], 0
        training = self.model.training
        self.model.eval()
        try:
            for window in self._windows():
                batch.append(window)
                if len(batch) < cfg.eval_batch_size:
                    continue
                with torch.inference_mode():
                    gt = torch.from_numpy(np.stack([g for _, g in batch])).to(device)
                    lr = (None if self.family == "pfnl" else
                          torch.from_numpy(np.stack([x for x, _ in batch])).to(device))
                    mse, ssim = self._batch(lr, gt)
                    mse_acc.append(mse.cpu().numpy())
                    if ssim is not None:
                        ssim_acc.append(ssim.cpu().numpy())
                print_fn(f"\tEval batch {cnt} - {cnt + cfg.eval_batch_size} ...")
                cnt += cfg.eval_batch_size
                batch = []
            # leftover windows dropped, like the reference (pfnl.py:127)
        finally:
            self.model.train(training)

        if not mse_acc:
            raise RuntimeError("no eval batches produced (dataset too small?)")
        mse_acc = np.concatenate(mse_acc, 0)
        psnr_avg = np.mean(psnr_from_mse(mse_acc), axis=0)
        mse_avg = np.mean(mse_acc, axis=0)
        print_fn(f"Eval PSNR: {psnr_avg}, MSE: {mse_avg}")
        ssim_avg = np.mean(np.concatenate(ssim_acc, 0), axis=0) if ssim_acc else None

        if log_path:
            os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
            if ssim_avg is not None:
                line = (f'"Iter": {step} , "MSE": {_truncated(mse_avg, 1e8)}, '
                        f'"PSNR": {_truncated(psnr_avg, 1e8)}, "SSIM": {_truncated(ssim_avg, 1e8)}')
            else:
                line = (f'"Iter": {step} , "PSNR": {_truncated(psnr_avg, 1e6)}, '
                        f'"MSE": {_truncated(mse_avg, 1e6)}')
            with open(log_path, "a+") as f:
                f.write("{" + line + "}\n")
        if ssim_avg is not None:
            return psnr_avg, mse_avg, ssim_avg
        return psnr_avg, mse_avg
