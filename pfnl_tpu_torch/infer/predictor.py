"""Inference API — counterpart of pfnl_tpu/infer/predictor.py for the
window-batched PFNL family, with the reference's public surface:

  * test_video_truth(path, name, part): read `truth/*.png`, degrade on the
    model's device, slide edge-clamped temporal windows, run chunked
    batches, save PNGs, print the total and average seconds per chunk
    excluding the first (reference model/pfnl.py:203-262).
  * test_video_lr(path, name, part): the same from `blur{scale}/*.png`.
  * testvideos(path, start, name): every sequence of a dataset directory
    (model/pfnl.py:322-332).

Frames are read through `source` and written through `sink`, by default
PNG files on disk through pfnl_tpu.utils.image_io (cv2 or PIL, imported
on first use).  `MemoryFrames` holds them in a dict instead, for machines
without a PNG codec.
"""

import glob
import os
import time

import numpy as np
import torch

from pfnl_tpu_torch.data.manifest import scan_dataset_dir
from pfnl_tpu_torch.ops.degrade import downsample_4d


class PngFrames:
    """PNG frames on disk, through pfnl_tpu.utils.image_io."""

    @staticmethod
    def list(directory: str):
        return sorted(glob.glob(os.path.join(directory, "*.png")))

    @staticmethod
    def read(path: str) -> np.ndarray:
        from pfnl_tpu.utils.image_io import imread

        return imread(path)

    @staticmethod
    def write(path: str, img: np.ndarray) -> None:
        from pfnl_tpu.utils.image_io import imsave

        os.makedirs(os.path.dirname(path), exist_ok=True)
        imsave(path, img)


class MemoryFrames:
    """uint8 [H,W,3] frames in a dict keyed by path."""

    def __init__(self, frames=None):
        self.frames = dict(frames or {})

    def list(self, directory: str):
        return sorted(p for p in self.frames
                      if os.path.dirname(p) == directory and p.endswith(".png"))

    def read(self, path: str) -> np.ndarray:
        return self.frames[path]

    def write(self, path: str, img: np.ndarray) -> None:
        self.frames[path] = img


def to_uint8_img(x: np.ndarray) -> np.ndarray:
    """float [0,1] -> uint8, round then clip (reference model/pfnl.py:255-257)."""
    return np.round(np.clip(x * 255.0, 0, 255)).astype(np.uint8)


def _clipped_windows(num_frames: int, t: int) -> np.ndarray:
    """[F, T] edge-clamped sliding-window indices (pfnl.py:238-241)."""
    idx = np.arange(num_frames)[:, None] + np.arange(t)[None, :] - t // 2
    return np.clip(idx, 0, num_frames - 1)


class Predictor:
    def __init__(self, model, batch_windows: int = 4, source=None, sink=None):
        """model: a window model ([N,T,h,w,3] -> [N,1,Sh,Sw,3], e.g. PFNL)
        whose parameters sit on the device to run on.  batch_windows: the
        least number of windows per forward batch."""
        self.model = model
        self.num_frames = model.num_frames
        self.scale = model.scale
        self.device = next(model.parameters()).device
        self.batch_windows = batch_windows
        self.source = source or PngFrames()
        self.sink = sink or PngFrames()

    def _read_video(self, directory: str) -> np.ndarray:
        files = self.source.list(directory)
        if not files:
            raise FileNotFoundError(f"no *.png frames under {directory}")
        return np.stack([self.source.read(f) for f in files]).astype(np.float32) / 255.0

    def _degrade_video(self, imgs: np.ndarray, chunk: int = 16) -> np.ndarray:
        """HR video [F,H,W,3] float -> LR [F,h,w,3], chunked on the device;
        a ragged last chunk is padded to the chunk size and the extras
        dropped, as the JAX package does."""
        outs = []
        f = imgs.shape[0]
        for i in range(0, f, chunk):
            part = imgs[i:i + chunk]
            pad = 0
            if part.shape[0] < chunk and f > chunk:
                pad = chunk - part.shape[0]
                part = np.concatenate([part, part[-1:].repeat(pad, 0)])
            with torch.inference_mode():
                lr = downsample_4d(torch.from_numpy(part).to(self.device), scale=self.scale)
            out = lr.cpu().numpy()
            outs.append(out[:out.shape[0] - pad] if pad else out)
        return np.concatenate(outs, 0)

    def _run_windows(self, lrs: np.ndarray, save_path: str, part: int):
        t = self.num_frames
        # pad LR frames to an even size (space_to_depth needs it) and crop
        # the HR output back
        h0, w0 = lrs.shape[1], lrs.shape[2]
        padh, padw = (-h0) % 2, (-w0) % 2
        if padh or padw:
            lrs = np.pad(lrs, [[0, 0], [0, padh], [0, padw], [0, 0]], "edge")
        out_h, out_w = h0 * self.scale, w0 * self.scale
        max_frame = lrs.shape[0]
        part = min(part, max_frame)
        num_once = max_frame // part + (0 if max_frame % part == 0 else 1)
        num_once = min(max(num_once, self.batch_windows), max_frame)
        windows = _clipped_windows(max_frame, t)  # [F, T]

        print(f"Save at {save_path}")
        print(f"{max_frame} Inputs With Shape {lrs.shape[1:]}")
        all_time = []
        n_chunks = (max_frame + num_once - 1) // num_once
        for i in range(n_chunks):
            sel = windows[i * num_once:(i + 1) * num_once]
            pad = num_once - sel.shape[0]
            if pad:  # as the JAX package does: every batch has one shape
                sel = np.concatenate([sel, sel[-1:].repeat(pad, 0)])
            st = time.time()
            with torch.inference_mode():
                sr = self.model(torch.from_numpy(lrs[sel]).to(self.device))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            sr = sr.cpu().numpy()
            for j in range(num_once - pad):
                self.sink.write(os.path.join(save_path, f"{i * num_once + j:0>4}.png"),
                                to_uint8_img(sr[j][0][:out_h, :out_w]))
            all_time.append(time.time() - st)
        all_time = np.array(all_time)
        avg = np.mean(all_time[1:]) if len(all_time) > 1 else float(all_time[0])
        print(f"spent {np.sum(all_time)} s in total and {avg} s in average")
        return all_time

    def test_video_truth(self, path: str, name: str = "result", part: int = 1000):
        """Degrade truth/*.png on the device, then super-resolve."""
        lrs = self._degrade_video(self._read_video(os.path.join(path, "truth")))
        return self._run_windows(lrs, os.path.join(path, name), part)

    def test_video_lr(self, path: str, name: str = "result", part: int = 1000):
        """Super-resolve pre-rendered blur{scale}/*.png."""
        lrs = self._read_video(os.path.join(path, f"blur{self.scale}"))
        return self._run_windows(lrs, os.path.join(path, name), part)

    def testvideos(self, path: str, start: int = 0, name: str = "result"):
        """test_video_truth on every sequence subdirectory from index
        `start` on (PFNL degrades truth/, as the reference does)."""
        for k in scan_dataset_dir(path)[start:]:
            self.test_video_truth(k, name=name)
