"""Periodic validation (counterpart: pfnl_tpu/eval/evaluator.py:46-214),
PFNL family: GT-only windows, degraded on the device, RGB MSE against the
centre GT frame (reference model/pfnl.py:94-149).

  * window centres at frame 15, 47, 79, ... (stride 32);
  * 7-frame windows edge-clamped at sequence boundaries;
  * GT cropped [border : out_h+border] with border=8;
  * batches of eval_batch_size; LEFTOVER windows that don't fill a batch
    are dropped (reference quirk, model/pfnl.py:127);
  * PSNR = 10*log10(1/mse);
  * appends the reference's JSON-ish log line with its 1e-6 truncation.

The forward runs under torch.inference_mode(), so at eval_in_size 128x240
(7680 non-local positions) a CUDA model runs kernel 1.
"""

import os
from typing import Callable, List, Optional

import numpy as np
import torch

from pfnl_tpu_torch.data.frames import PngFrames
from pfnl_tpu_torch.data.manifest import load_manifest
from pfnl_tpu_torch.eval.metrics import psnr_from_mse
from pfnl_tpu_torch.ops.degrade import downsample


def _clipped_window(idx0: int, radius: int, max_frame: int, length: int) -> List[int]:
    idx = np.arange(idx0 - radius, idx0 - radius + length)
    return np.clip(idx, 0, max_frame - 1).tolist()


class Evaluator:
    def __init__(self, cfg, model, center: int = 15, stride: int = 32, border: int = 8,
                 source=None):
        """model: the PFNL to evaluate, on its device.  source: the frame
        store the eval list's paths are read from (PngFrames by default)."""
        if cfg.model != "pfnl":
            raise NotImplementedError(f"evaluating {cfg.model!r} is not ported: PFNL only")
        self.cfg = cfg
        self.model = model
        self.center = center
        self.stride = stride
        self.border = border
        in_h, in_w = cfg.eval_in_size
        self.out_hw = (in_h * cfg.scale, in_w * cfg.scale)
        self.source = source or PngFrames()
        self.sequences = load_manifest(cfg.eval_list, cfg.scale)

    def _windows(self):
        """Yield each window's GT frames, [T, out_h, out_w, 3] float32."""
        t = self.cfg.num_frames
        out_h, out_w = self.out_hw
        b = self.border
        for seq in self.sequences:
            max_frame = len(seq.truth)
            for idx0 in range(self.center, max_frame, self.stride):
                yield np.stack([
                    self.source.read(seq.truth[i])[b:out_h + b, b:out_w + b].astype(np.float32)
                    / 255.0
                    for i in _clipped_window(idx0, t // 2, max_frame, t)])

    def run(self, step: int, log_path: Optional[str] = None, print_fn: Callable = print):
        """Returns (psnr_avg, mse_avg), each of shape [1]."""
        cfg = self.cfg
        device = next(self.model.parameters()).device
        mse_acc, batch, cnt = [], [], 0
        for gt in self._windows():
            batch.append(gt)
            if len(batch) < cfg.eval_batch_size:
                continue
            with torch.inference_mode():
                gt_b = torch.from_numpy(np.stack(batch)).to(device)
                sr = self.model(downsample(gt_b, scale=cfg.scale))
                center = gt_b[:, cfg.num_frames // 2:cfg.num_frames // 2 + 1]
                mse_acc.append(((sr - center) ** 2).mean(dim=(2, 3, 4)).cpu().numpy())
            print_fn(f"\tEval batch {cnt} - {cnt + cfg.eval_batch_size} ...")
            cnt += cfg.eval_batch_size
            batch = []
        # leftover windows dropped, like the reference (pfnl.py:127)

        if not mse_acc:
            raise RuntimeError("no eval batches produced (dataset too small?)")
        mse_acc = np.concatenate(mse_acc, 0)
        psnr_acc = psnr_from_mse(mse_acc)
        mse_avg = np.mean(mse_acc, axis=0)
        psnr_avg = np.mean(psnr_acc, axis=0)
        print_fn(f"Eval PSNR: {psnr_avg}, MSE: {mse_avg}")

        if log_path:
            os.makedirs(os.path.dirname(os.path.abspath(log_path)), exist_ok=True)
            q = 1e6
            m = (mse_avg * q).astype(np.int64) / q
            p = (psnr_avg * q).astype(np.int64) / q
            with open(log_path, "a+") as f:
                f.write("{" + f'"Iter": {step} , "PSNR": {p.tolist()}, "MSE": {m.tolist()}' + "}\n")
        return psnr_avg, mse_avg
