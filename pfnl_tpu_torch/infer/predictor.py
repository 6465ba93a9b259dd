"""Inference API — counterpart of pfnl_tpu/infer/predictor.py, with the
reference's public surface:

  * test_video_truth(path, name, part): read `truth/*.png`, degrade on the
    model's device, super-resolve, save PNGs, print the total and average
    seconds per chunk excluding the first (reference model/pfnl.py:203-262).
  * test_video_lr(path, name, part): the same from `blur{scale}/*.png`;
    `testvideo(path, name, part)` is its VESPCN-family name
    (model/vespcn.py:298).
  * testvideos(path, start, name, from_truth): every sequence of a dataset
    directory (model/pfnl.py:322-332); PFNL degrades `truth/`, the Y
    families, FRVSR and DUF read `blur{scale}/`, unless from_truth says
    otherwise.

The window families run edge-clamped temporal windows in batches, their
LR frames edge-padded to a multiple of the model's `lr_multiple` and
their HR output cropped back; a recurrent model (FRVSR) runs `step` frame
by frame, carrying its state on the device (`_run_recurrent`).  What
differs is read from the model:
  * recurrent: True (FRVSR) runs `_run_recurrent`, False the windows;
  * y_channel: False (PFNL, DUF) saves the model's RGB output as it comes; True
    (VESPCN, MCResNet, LTDVSR, DRVSR) serves through `serve_rgb`, which
    pairs the SR Y of the last output frame with the bicubically upscaled
    CbCr of the centre frame and converts back to RGB
    (model/vespcn.py:334-346), passing the model's `serve_kwargs`;
  * reads_truth: what `testvideos` reads by default.

Frames are read through `source` and written through `sink`, frame stores
of data/frames.py: by default `PngFrames`, PNG files on disk;
`MemoryFrames` holds them in a dict instead, for frames that never touch
the disk.
"""

import os
import time

import numpy as np
import torch

from pfnl_tpu_torch.data.frames import MemoryFrames, PngFrames  # noqa: F401  (public here too)
from pfnl_tpu_torch.ops.color import rgb2ycbcr, ycbcr2rgb
from pfnl_tpu_torch.ops.degrade import downsample_4d
from pfnl_tpu_torch.ops.resize import resize_bicubic


def to_uint8_img(x: np.ndarray) -> np.ndarray:
    """float [0,1] -> uint8, round then clip (reference model/pfnl.py:255-257)."""
    return np.round(np.clip(x * 255.0, 0, 255)).astype(np.uint8)


def to_uint8(x: torch.Tensor) -> torch.Tensor:
    """`to_uint8_img` on the tensor's device: round(clip(x*255, 0, 255)) in
    float32, half to even as numpy rounds, so the bytes are the same; the
    Predictor converts on the card and downloads a quarter of the bytes."""
    return torch.round(torch.clamp(x.float() * 255.0, 0, 255)).to(torch.uint8)


def _clipped_windows(num_frames: int, t: int) -> np.ndarray:
    """[F, T] edge-clamped sliding-window indices (pfnl.py:238-241)."""
    idx = np.arange(num_frames)[:, None] + np.arange(t)[None, :] - t // 2
    return np.clip(idx, 0, num_frames - 1)


def serve_rgb(model, clip: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """A Y family's whole serving program for a window batch [B,T,h,w,3]
    (pfnl_tpu `make_serving_fn`): the SR Y of the last output frame, the
    bicubically upscaled CbCr of the centre frame, ycbcr2rgb -> [B,H,W,3]
    float32.  The model's `serve_kwargs` go to its forward (DRVSR:
    last_only, one decode)."""
    sr_y = model(clip, plain=plain, **model.serve_kwargs)["sr"][:, -1]  # [B,H,W,1]
    ycc = rgb2ycbcr(clip[:, clip.shape[1] // 2])
    cbcr = resize_bicubic(ycc, (sr_y.shape[1], sr_y.shape[2]))[..., 1:3]
    return ycbcr2rgb(torch.cat([sr_y, cbcr], -1))


def serve(model, clip: torch.Tensor, plain: bool = False) -> torch.Tensor:
    """A window batch [B,T,h,w,3] through the model's whole serving program
    -> RGB [B,H,W,3] float32: `serve_rgb` for a Y family, the model's own
    RGB output otherwise (PFNL, DUF)."""
    if model.y_channel:
        return serve_rgb(model, clip, plain)
    return model(clip, plain=plain)[:, 0]


class Predictor:
    def __init__(self, model, batch_windows: int = 4, source=None, sink=None, devices=None):
        """model: a window model of one family (PFNL, DUF: [N,T,h,w,3] ->
        [N,1,Sh,Sw,3]; a Y family: a dict whose "sr" is [N,T',Sh,Sw,1]) or
        a recurrent one (FRVSR: `step`), with the serving attributes above,
        whose parameters sit on the device to run on.  batch_windows: the
        least number of windows per forward batch.

        devices: several devices to serve window batches on, data-parallel
        (JAX: `mesh=`): a replica of the model on each, every batch split
        evenly over them by rows (parallel/spmd.py `sharded_apply_dp`), each
        shard's serving program and uint8 conversion on its device, the
        frames gathered in order on the first, which uploads the batches.
        batch_windows is rounded up to a multiple of their count.  The
        recurrent path (FRVSR) stays on the model's device, as in JAX."""
        self.model = model
        self.num_frames = model.num_frames
        self.scale = model.scale
        self.device = next(model.parameters()).device
        self.source = source or PngFrames()
        self.sink = sink or PngFrames()
        self._serve = lambda clip: to_uint8(serve(self.model, clip))
        if devices is not None and not model.recurrent:
            from pfnl_tpu_torch.parallel.spmd import device_list, replicate, sharded_apply_dp

            devices = device_list(devices)
            replicas = replicate(model, devices)
            self.device = devices[0]
            self._serve = sharded_apply_dp(
                lambda device, clip: to_uint8(serve(replicas[device], clip)), devices)
            batch_windows = -(-batch_windows // len(devices)) * len(devices)
        self.batch_windows = batch_windows

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
        """Window batches through the model's serving program.  LR
        frames are edge-padded to a multiple of the model's lr_multiple
        and the HR output is cropped back.

        One batch stays pending, as in the JAX Predictor: batch i is
        dispatched before batch i-1 is written out, so on a CUDA device
        batch i-1's download and sink overlap batch i's forward.  Batch 0
        runs alone, so the warm-up lands in all_time[0]; all_time[i] is
        dispatch i plus flush i-1, and the last flush is added to
        all_time[-1].  On CUDA a batch uploads the LR frames its windows
        span (at most batch + T - 1) and their indices, and gathers the
        windows on the card; its uint8 frames come down into pinned
        memory.  Two pinned buffers of each are used in turn, and a flush
        waits on its batch's CUDA event only."""
        t = self.num_frames
        mult = self.model.lr_multiple
        h0, w0 = lrs.shape[1], lrs.shape[2]
        padh, padw = (-h0) % mult, (-w0) % mult
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
        cuda = self.device.type == "cuda"
        # CUDA: (LR frames, window indices) and uint8 outputs, two each; batch i uses [i % 2]
        pinned_in, pinned_out = [], []

        def dispatch(i, sel):
            """Batch i's upload, forward, uint8 conversion and download,
            enqueued; returns (host uint8 [B,H,W,3], its CUDA event)."""
            if not cuda:
                with torch.inference_mode():
                    return self._serve(torch.from_numpy(lrs[sel])), None
            while len(pinned_in) < 2:
                pinned_in.append((torch.empty((num_once + t - 1,) + lrs.shape[1:],
                                              dtype=torch.from_numpy(lrs[:1]).dtype,
                                              pin_memory=True),
                                  torch.empty(sel.shape, dtype=torch.int64, pin_memory=True)))
            # batch i-2's uploads from these buffers preceded its forward, which flush(i-2)
            # waited on
            frames, idx = pinned_in[i % 2]
            lo, hi = int(sel.min()), int(sel.max()) + 1
            np.copyto(frames.numpy()[:hi - lo], lrs[lo:hi])
            np.copyto(idx.numpy(), sel - lo)
            with torch.inference_mode():
                span = frames[:hi - lo].to(self.device, non_blocking=True)
                clip = span[idx.to(self.device, non_blocking=True)]  # [B,T,h,w,3]
                u8 = self._serve(clip)
            while len(pinned_out) < 2:
                pinned_out.append(torch.empty(u8.shape, dtype=torch.uint8, pin_memory=True))
            host = pinned_out[i % 2]  # batch i-2's frames were written out by flush(i-2)
            host.copy_(u8, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
            return host, done

        def flush(host, done, n_valid, base):
            if done is not None:
                done.synchronize()
            frames = host.numpy()
            for j in range(n_valid):  # a copy: the pinned buffer is reused two batches on
                self.sink.write(os.path.join(save_path, f"{base + j:0>4}.png"),
                                frames[j, :out_h, :out_w].copy())

        pending = None  # (host uint8, event, valid frames, first frame index)
        for i in range(n_chunks):
            sel = windows[i * num_once:(i + 1) * num_once]
            pad = num_once - sel.shape[0]
            if pad:  # as the JAX package does: every batch has one shape
                sel = np.concatenate([sel, sel[-1:].repeat(pad, 0)])
            st = time.time()
            batch = (*dispatch(i, sel), num_once - pad, i * num_once)
            if i == 0:
                flush(*batch)
            else:
                if pending is not None:
                    flush(*pending)
                pending = batch
            all_time.append(time.time() - st)
        if pending is not None:
            st = time.time()
            flush(*pending)
            all_time[-1] += time.time() - st
        all_time = np.array(all_time)
        avg = np.mean(all_time[1:]) if len(all_time) > 1 else float(all_time[0])
        print(f"spent {np.sum(all_time)} s in total and {avg} s in average")
        return all_time

    def _run_recurrent(self, lrs: np.ndarray, save_path: str, chunk_frames: int = 32):
        """The O(1)-state recurrence of a recurrent model (pfnl_tpu
        `_run_recurrent`): frame 0 through `step(x)` alone, the warm-up in
        all_time[0]; then chunks of `chunk_frames` frames, each frame through
        `step(x, xp, est)`.  The state (the previous LR frame, the previous
        SR exactly as `step` returned it, in the compute dtype: not clipped,
        not rounded to uint8, not widened) stays on the device across
        chunks.  Each SR frame goes to uint8 on the device.

        On CUDA a chunk uploads its LR frames (and the one before) from a
        pinned buffer, and its uint8 frames come down into a pinned buffer,
        two of each, made during the warm-up and used in turn; chunk i is
        enqueued before chunk i-1 is written out, which waits on chunk
        i-1's CUDA event only, so the host does not wait on the device
        inside a chunk.  No chunk is
        padded (there is no compile to spare), so the frames do not depend
        on chunk_frames.  The average is per frame, over frames 1..F-1
        (the reference's per-frame print, model/frvsr.py:301)."""
        if chunk_frames < 1:
            raise ValueError(f"chunk_frames must be >= 1, got {chunk_frames}")
        print(f"Save at {save_path}")
        print(f"{lrs.shape[0]} Inputs With Shape {lrs.shape[1:]}")
        f = lrs.shape[0]
        if f == 0:
            return np.array([])
        cuda = self.device.type == "cuda"
        kc = min(chunk_frames, max(f - 1, 1))
        st = time.time()
        with torch.inference_mode():
            sr = self.model.step(torch.from_numpy(lrs[0:1]).to(self.device))
            first = to_uint8(sr[0])
        pinned_in, pinned_out = [], []  # chunk i uses [i % 2]
        if cuda:  # pinning host memory is slow: part of the warm-up
            for _ in range(2):
                pinned_in.append(torch.empty((kc + 1,) + lrs.shape[1:], dtype=torch.float32,
                                             pin_memory=True))
                pinned_out.append(torch.empty((kc,) + first.shape, dtype=torch.uint8,
                                              pin_memory=True))
        self.sink.write(os.path.join(save_path, "0000.png"), first.cpu().numpy())
        all_time = [time.time() - st]

        def dispatch(i, lo, k, sr):
            """Frames [lo, lo+k) through `step` from state sr, enqueued;
            returns (host uint8 [k,H,W,3], its CUDA event or None, the last SR)."""
            with torch.inference_mode():
                if cuda:
                    # chunk i-2's upload from this buffer and its frames in pinned_out[i % 2]
                    # preceded its event, which flush(i-2) waited on
                    buf, host = pinned_in[i % 2], pinned_out[i % 2]
                    np.copyto(buf.numpy()[:k + 1], lrs[lo - 1:lo + k])
                    frames = buf[:k + 1].to(self.device, non_blocking=True)
                else:
                    frames = torch.from_numpy(lrs[lo - 1:lo + k])
                    host = torch.empty((k,) + first.shape, dtype=torch.uint8)
                for j in range(k):
                    sr = self.model.step(frames[j + 1:j + 2], frames[j:j + 1], sr)
                    host[j].copy_(to_uint8(sr[0]), non_blocking=cuda)
            done = None
            if cuda:
                done = torch.cuda.Event()
                done.record()
            return host, done, sr

        def flush(host, done, k, base):
            if done is not None:
                done.synchronize()
            frames = host.numpy()
            for j in range(k):  # a copy: the pinned buffer is reused two chunks on
                self.sink.write(os.path.join(save_path, f"{base + j:0>4}.png"), frames[j].copy())

        pending = None  # (host uint8, event, frames, first frame index)
        i, lo = 0, 1
        while lo < f:
            k = min(kc, f - lo)
            st = time.time()
            host, done, sr = dispatch(i, lo, k, sr)
            if pending is not None:
                flush(*pending)
            pending = (host, done, k, lo)
            all_time.append(time.time() - st)
            i, lo = i + 1, lo + k
        if pending is not None:
            st = time.time()
            flush(*pending)
            all_time[-1] += time.time() - st
        all_time = np.array(all_time)
        avg = np.sum(all_time[1:]) / (f - 1) if f > 1 else float(all_time[0])
        print(f"spent {np.sum(all_time)} s in total and {avg} s in average")
        return all_time

    def _run(self, lrs: np.ndarray, save_path: str, part: int):
        if self.model.recurrent:
            return self._run_recurrent(lrs, save_path)
        return self._run_windows(lrs, save_path, part)

    def test_video_truth(self, path: str, name: str = "result", part: int = 1000):
        """Degrade truth/*.png on the device, then super-resolve."""
        lrs = self._degrade_video(self._read_video(os.path.join(path, "truth")))
        return self._run(lrs, os.path.join(path, name), part)

    def test_video_lr(self, path: str, name: str = "result", part: int = 1000):
        """Super-resolve pre-rendered blur{scale}/*.png."""
        lrs = self._read_video(os.path.join(path, f"blur{self.scale}"))
        return self._run(lrs, os.path.join(path, name), part)

    def testvideo(self, path: str, name: str = "result", part: int = 1000):
        """The VESPCN family's name for test_video_lr (model/vespcn.py:298)."""
        return self.test_video_lr(path, name, part)

    def testvideos(self, path: str, start: int = 0, name: str = "result",
                   from_truth: bool = None):
        """Every sequence subdirectory from index `start` on.  from_truth
        defaults to the model's reads_truth, the JAX package's behaviour:
        PFNL degrades truth/, the Y families, FRVSR and DUF read
        blur{scale}/."""
        if from_truth is None:
            from_truth = self.model.reads_truth
        run = self.test_video_truth if from_truth else self.test_video_lr
        for k in self.source.sequences(path)[start:]:
            run(k, name=name)
