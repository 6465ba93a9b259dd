"""Training input pipeline (counterpart: pfnl_tpu/data/pipeline.py).

Host side: `TrainPipeline`, a small thread pool that samples (sequence,
window, crop) uniformly, reads frames through a frame store
(data/frames.py) and crops them into uint8 numpy batches (the reference
used TF1 queue runners with 3 threads, model/base_model.py:196-198).  PNG
files on disk (`PngFrames`) are decoded and cropped a window at a time by
the port's native codec (native/), as the JAX pipeline does with its own;
`MemoryFrames` crops in numpy.  The sampler draws from numpy exactly as
the JAX package's does, so one seed gives both packages the same batches.

Device side: `device_augment_and_degrade` turns a uint8 batch on the
device into float training tensors: per-sample flips and transpose drawn
from an explicit torch.Generator on the batch's device, and for the
"single" producer the Gaussian blur + decimation, so the batch never makes
a device -> host -> device round trip (reference model/pfnl.py:194-195).

Producer modes mirror the reference's three input producers:
  single  GT-only, on-the-fly degradation   (base_model.py:150-199, PFNL)
  double  pre-rendered LR + center GT frame (base_model.py:89-148)
  frvsr   LR + all GT frames, no flip aug   (base_model.py:36-87)
"""

import queue
import threading
from typing import Dict, List

import numpy as np
import torch

from pfnl_tpu_torch import native
from pfnl_tpu_torch.data.frames import PngFrames
from pfnl_tpu_torch.data.manifest import Sequence
from pfnl_tpu_torch.ops.degrade import downsample


def _random_crop_coords(rng, h, w, size):
    return rng.integers(0, h - size + 1), rng.integers(0, w - size + 1)


def sample_flip_crop(rng, h, w, in_size, scale):
    """Crop offsets + flips for a pre-rendered LR/GT pair such that the
    flipped pair stays aligned.

    The degradation centers LR pixel i at GT pixel scale*i, so flipping an
    LR crop and the correspondingly-cropped GT patch misaligns the pair by
    scale-1 GT pixels: the reference's double_input_producer has this bug
    (base_model.py:97-103; CONVERGENCE.md bug 1).  Fix: when flipping along
    an axis, crop GT at scale*y0 - (scale-1) instead of scale*y0.

    Returns (y0, x0, gy, gx, flip_y, flip_x, transpose): LR crop offsets,
    GT crop offsets, and the flips to apply to both patches.
    """
    flip_y, flip_x, transpose = rng.random(3) < 0.5
    flip_y &= h - in_size >= 1  # need 1 LR px of margin for the GT shift
    flip_x &= w - in_size >= 1
    y0 = rng.integers(1 if flip_y else 0, h - in_size + 1)
    x0 = rng.integers(1 if flip_x else 0, w - in_size + 1)
    gy = y0 * scale - ((scale - 1) if flip_y else 0)
    gx = x0 * scale - ((scale - 1) if flip_x else 0)
    return y0, x0, gy, gx, flip_y, flip_x, transpose


class TrainPipeline:
    """Background-threaded sampler producing uint8 numpy batches."""

    def __init__(
        self,
        sequences: List[Sequence],
        mode: str,
        num_frames: int,
        in_size: int,
        scale: int,
        batch_size: int,
        seed: int = 0,
        num_threads: int = 2,
        prefetch: int = 4,
        augment: bool = True,
        source=None,
    ):
        """augment: for "double", alignment-preserving host-side flips
        (sample_flip_crop); "single" augments on the device (flip before
        degrade is exact); "frvsr" never augments (reference parity).
        source: the frame store the sequences' paths are read from
        (PngFrames by default)."""
        if mode not in ("single", "double", "frvsr"):
            raise ValueError(f"unknown producer mode {mode!r}")
        self.augment = augment
        self.sequences = [s for s in sequences if len(s.truth) >= num_frames]
        if not self.sequences:
            raise ValueError("no usable sequences (need >= num_frames truth frames)")
        if mode in ("double", "frvsr"):
            for s in self.sequences:
                if len(s.blur) != len(s.truth):
                    raise ValueError(f"{s.path}: blur/truth frame count mismatch")
        self.mode = mode
        self.num_frames = num_frames
        self.in_size = in_size
        self.scale = scale
        self.gt_size = in_size * scale
        self.batch_size = batch_size
        self.source = source or PngFrames()
        self._native = isinstance(self.source, PngFrames)
        self._size_cache: Dict[str, tuple] = {}
        self._size_lock = threading.Lock()
        self._q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._worker, args=(seed + i,), daemon=True)
            for i in range(num_threads)
        ]
        for t in self._threads:
            t.start()

    # --- host sampling -------------------------------------------------
    def _frame_size(self, path: str):
        with self._size_lock:
            size = self._size_cache.get(path)
        if size is None:
            size = native.png_size(path) if self._native else self.source.read(path).shape[:2]
            with self._size_lock:
                self._size_cache[path] = size
        return size

    def _decode_window(self, paths, y0: int, x0: int, size: int) -> np.ndarray:
        if self._native:
            n = len(paths)
            return native.decode_crop_batch(list(paths), [y0] * n, [x0] * n, (size, size),
                                            threads=min(4, n))
        return np.stack([self.source.read(p)[y0:y0 + size, x0:x0 + size] for p in paths])

    def _sample_one(self, rng) -> Dict[str, np.ndarray]:
        seq = self.sequences[rng.integers(len(self.sequences))]
        t0 = rng.integers(0, len(seq.truth) - self.num_frames + 1)
        idx = list(range(t0, t0 + self.num_frames))
        if self.mode == "single":
            h, w = self._frame_size(seq.truth[idx[0]])
            y0, x0 = _random_crop_coords(rng, h, w, self.gt_size)
            gt = self._decode_window([seq.truth[i] for i in idx], y0, x0, self.gt_size)
            return {"gt": gt}
        # double / frvsr: aligned LR + GT crops
        h, w = self._frame_size(seq.blur[idx[0]])
        if self.mode == "double" and self.augment:
            y0, x0, gy, gx, fy, fx, ftr = sample_flip_crop(rng, h, w, self.in_size, self.scale)
        else:
            y0, x0 = _random_crop_coords(rng, h, w, self.in_size)
            gy, gx = y0 * self.scale, x0 * self.scale
            fy = fx = ftr = False
        lr = self._decode_window([seq.blur[i] for i in idx], y0, x0, self.in_size)
        if self.mode == "double":
            gt = self._decode_window([seq.truth[t0 + self.num_frames // 2]], gy, gx,
                                     self.gt_size)
        else:
            gt = self._decode_window([seq.truth[i] for i in idx], gy, gx, self.gt_size)
        if fy:
            lr, gt = lr[:, ::-1], gt[:, ::-1]
        if fx:
            lr, gt = lr[:, :, ::-1], gt[:, :, ::-1]
        if ftr:
            lr, gt = lr.transpose(0, 2, 1, 3), gt.transpose(0, 2, 1, 3)
        if fy or fx or ftr:
            lr, gt = np.ascontiguousarray(lr), np.ascontiguousarray(gt)
        return {"lr": lr, "gt": gt}

    def _worker(self, seed: int):
        rng = np.random.default_rng(seed)
        while not self._stop.is_set():
            samples = [self._sample_one(rng) for _ in range(self.batch_size)]
            batch = {k: np.stack([s[k] for s in samples]) for k in samples[0]}
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.5)
                    break
                except queue.Full:
                    continue

    def get_batch(self) -> Dict[str, np.ndarray]:
        return self._q.get()

    def close(self):
        """Stop the workers and wait for them (each notices within 0.5 s)."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        for t in self._threads:
            t.join(timeout=5.0)


# --- device-side augmentation + degradation ------------------------------


def _flip_clip(clips, do_h, do_w, do_t):
    """clips [B,T,H,W,C]; do_h/do_w/do_t [B] bool: per clip, flip rows,
    flip columns, then swap rows and columns (base_model.py:97-103,174-177)."""
    sel = lambda m: m.view(-1, 1, 1, 1, 1)  # noqa: E731
    clips = torch.where(sel(do_h), clips.flip(2), clips)
    clips = torch.where(sel(do_w), clips.flip(3), clips)
    return torch.where(sel(do_t), clips.transpose(2, 3), clips)


def device_augment_and_degrade(batch, generator, mode: str, scale: int, augment: bool = True,
                               part=(0, 1), legacy_double_flip: bool = False):
    """uint8 batch of tensors on the device -> float LR/GT training tensors.

    single: {"gt" [B,T,S,S,3]} -> lr [B,T,s,s,3], gt center [B,1,S,S,3]
            (flip THEN degrade, so augmented pairs stay exactly aligned);
            the flips [B,3] (rows, columns, transpose) are drawn uniformly
            from `generator`, which lives on the batch's device.  part
            (i, n): the batch is part i of n equal parts of a global batch
            (a rank's rows under data-parallel training); the flips of the
            whole global batch are drawn and this part's rows taken, so the
            ranks together flip as one process at the global batch does
    double: {"lr","gt"} -> pass-through; flips happen on the host with
            alignment-corrected GT crops (sample_flip_crop).  Flipping a
            pre-rendered LR/GT pair "consistently" here misaligns it by
            scale-1 GT px: the reference's bug (base_model.py:97-103) is
            kept behind legacy_double_flip=True for parity studies, the
            flips drawn as in single mode and the same applied to lr and gt
    frvsr:  {"lr","gt"} -> no augmentation (reference parity)
    """
    if mode == "single":
        gt = batch["gt"].float() / 255.0
        b, t = gt.shape[:2]
        if augment:
            f = _draw_flips(generator, b, part, gt.device)
            gt = _flip_clip(gt, f[:, 0], f[:, 1], f[:, 2])
        lr = downsample(gt, scale=scale)
        return lr, gt[:, t // 2:t // 2 + 1]
    lr, gt = batch["lr"].float() / 255.0, batch["gt"].float() / 255.0
    if mode == "double" and augment and legacy_double_flip:
        f = _draw_flips(generator, lr.shape[0], part, lr.device)
        lr = _flip_clip(lr, f[:, 0], f[:, 1], f[:, 2])
        gt = _flip_clip(gt, f[:, 0], f[:, 1], f[:, 2])
    return lr, gt


def _draw_flips(generator, b: int, part, device):
    """[b, 3] bool flips of part (i, n) of a global batch: the whole global
    batch's drawn uniformly from `generator`, this part's rows taken."""
    i, n = part
    f = torch.rand((b * n, 3), generator=generator, device=device)
    return f[i * b:(i + 1) * b] < 0.5
