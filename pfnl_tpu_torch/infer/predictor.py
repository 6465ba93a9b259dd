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

Both run through one serving loop (`_pipeline`) over units: a window
batch, or FRVSR's frame 0 and then its chunks of frames.  Unit 0 is
dispatched and written out alone, so the warm-up lands in all_time[0];
from then on unit i is dispatched before unit i-1 is written out, so on a
CUDA device unit i-1's download and sink overlap unit i's compute, and
all_time[i] is dispatch i plus flush i-1 (the last flush is added to
all_time[-1]).  A dispatch copies the unit's host arrays into a staging
slot, uploads them with `.to(device, non_blocking=True)` (on the CPU the
slot itself), computes on the device, converts to uint8 there and copies
the frames into the slot's uint8 buffer; a flush waits for them and
writes them.  The ring has two slots, used in turn and made during unit
0's dispatch: pinned on CUDA, where each unit records a CUDA event that
its flush waits on, plain host memory on the CPU.

Frames are read through `source` and written through `sink`, frame stores
of data/frames.py: by default `PngFrames`, PNG files on disk;
`MemoryFrames` holds them in a dict instead, for frames that never touch
the disk.

Each clip runs under the host spans of utils/spans.py (recorded only
while a torch.profiler records): "predictor.clip" around the whole call
(counts: frames, the HR frames delivered; windows, those computed;
padded, those computed only to fill the last batch), "predictor.read"
around everything before the first dispatch, and "predictor.dispatch",
"predictor.wait" (the host waiting on the device) and "predictor.write"
(the sink) for each unit.
"""

import os
import time

import numpy as np
import torch

from pfnl_tpu_torch.data.frames import MemoryFrames, PngFrames  # noqa: F401  (public here too)
from pfnl_tpu_torch.ops.color import rgb2ycbcr, ycbcr2rgb
from pfnl_tpu_torch.ops.degrade import downsample_4d
from pfnl_tpu_torch.ops.resize import resize_bicubic
from pfnl_tpu_torch.utils.spans import span


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

    def _edge_pad(self, lrs: np.ndarray) -> np.ndarray:
        """LR frames [F,h,w,3] edge-padded to a multiple of the model's
        lr_multiple."""
        mult = self.model.lr_multiple
        padh, padw = (-lrs.shape[1]) % mult, (-lrs.shape[2]) % mult
        if padh or padw:
            lrs = np.pad(lrs, [[0, 0], [0, padh], [0, padw], [0, 0]], "edge")
        return lrs

    def _pipeline(self, lrs, units, compute, lr_hw, save_path: str, avg_over: int):
        """The serving loop of both paths (module docstring); returns all_time.
        units: (host arrays, its LR frames first; first frame index n0;
        frames to write n);
        compute(i, *the arrays on the device) -> uint8 [>=n,H,W,3] on the
        device, frames n0.. cropped to lr_hw times the scale.  The average
        printed is sum(all_time[1:]) / avg_over, all_time[0] when it is 0."""
        print(f"Save at {save_path}")
        print(f"{lrs.shape[0]} Inputs With Shape {lrs.shape[1:]}")
        if not units:
            return np.array([])
        out_h, out_w = lr_hw[0] * self.scale, lr_hw[1] * self.scale
        cuda = self.device.type == "cuda"
        ring = []  # two slots [host input buffers..., host uint8 frames]; unit i uses ring[i % 2]

        def dispatch(i, arrays, n):
            """Unit i staged, uploaded, computed and its frames downloaded,
            enqueued; returns (host uint8 frames, their CUDA event or None)."""
            if not ring:  # pinning host memory is slow: part of unit 0, the warm-up
                h, w = arrays[0].shape[1:3]
                bufs = [((max(len(u[0][k]) for u in units),) + a.shape[1:],
                         torch.from_numpy(a).dtype) for k, a in enumerate(arrays)]
                bufs.append(((max(u[2] for u in units), h * self.scale, w * self.scale, 3),
                             torch.uint8))
                ring.extend([torch.empty(shape, dtype=dtype, pin_memory=cuda)
                             for shape, dtype in bufs] for _ in range(2))
            # unit i-2's upload from this slot and its download into it preceded its event,
            # which flush(i-2) waited on
            *ins, host = ring[i % 2]
            for buf, a in zip(ins, arrays):
                np.copyto(buf.numpy()[:len(a)], a)
            with torch.inference_mode():
                u8 = compute(i, *(buf[:len(a)].to(self.device, non_blocking=True)
                                  for buf, a in zip(ins, arrays)))
            host[:n].copy_(u8[:n], non_blocking=True)
            done = None
            if cuda:
                done = torch.cuda.Event()
                done.record()
            return host, done

        def flush(host, done, base, n):
            with span("predictor.wait"):
                if done is not None:
                    done.synchronize()
                frames = host.numpy()
            with span("predictor.write"):
                for j in range(n):  # a copy: the slot is reused two units on
                    self.sink.write(os.path.join(save_path, f"{base + j:0>4}.png"),
                                    frames[j, :out_h, :out_w].copy())

        all_time, pending = [], None  # pending: (host uint8, event, first frame index, frames)
        for i, (arrays, base, n) in enumerate(units):
            st = time.perf_counter()
            with span("predictor.dispatch"):
                unit = (*dispatch(i, arrays, n), base, n)
            if i == 0:
                flush(*unit)
            else:
                if pending is not None:
                    flush(*pending)
                pending = unit
            all_time.append(time.perf_counter() - st)
        if pending is not None:
            st = time.perf_counter()
            flush(*pending)
            all_time[-1] += time.perf_counter() - st
        all_time = np.array(all_time)
        avg = np.sum(all_time[1:]) / avg_over if avg_over else float(all_time[0])
        print(f"spent {np.sum(all_time)} s in total and {avg} s in average")
        return all_time

    def _run_windows(self, lrs: np.ndarray, save_path: str, part: int, lr_hw, clip):
        """Window batches through the model's serving program.  lrs are
        the LR frames edge-padded (`_edge_pad`), lr_hw their size before
        it: the HR output is cropped back to lr_hw times the scale.  A
        batch stages the LR frames its windows span (at most batch + T - 1)
        and the windows' indices into them, and gathers the windows on the
        device; the last batch is padded with copies of its last window, so
        every batch has one shape.  The counts of the clip's span are set
        on `clip`; the average printed is per batch, over batches 1 on."""
        max_frame = lrs.shape[0]
        part = min(part, max_frame)
        num_once = max_frame // part + (0 if max_frame % part == 0 else 1)
        num_once = min(max(num_once, self.batch_windows), max_frame)
        windows = _clipped_windows(max_frame, self.num_frames)  # [F, T]
        units = []
        for base in range(0, max_frame, num_once):
            sel = windows[base:base + num_once]
            n = sel.shape[0]
            sel = np.concatenate([sel, sel[-1:].repeat(num_once - n, 0)])
            lo, hi = int(sel.min()), int(sel.max()) + 1
            units.append(((lrs[lo:hi], sel - lo), base, n))
        clip.count(frames=max_frame, windows=len(units) * num_once,
                   padded=len(units) * num_once - max_frame)
        return self._pipeline(lrs, units, lambda i, frames, idx: self._serve(frames[idx]),
                              lr_hw, save_path, len(units) - 1)

    def _run_recurrent(self, lrs: np.ndarray, save_path: str, chunk_frames: int = 32):
        """The O(1)-state recurrence of a recurrent model (pfnl_tpu
        `_run_recurrent`): frame 0 through `step(x)` alone, the warm-up in
        all_time[0]; then chunks of `chunk_frames` frames, each staging its
        LR frames and the one before, each frame through `step(x, xp,
        est)`.  The state (the previous SR exactly as `step` returned it,
        in the compute dtype: not clipped, not rounded to uint8, not
        widened) stays on the device across chunks.  No chunk is padded
        (there is no compile to spare), so the frames do not depend on
        chunk_frames.  The average printed is per frame, over frames 1..F-1
        (the reference's per-frame print, model/frvsr.py:301)."""
        if chunk_frames < 1:
            raise ValueError(f"chunk_frames must be >= 1, got {chunk_frames}")
        f = lrs.shape[0]
        kc = min(chunk_frames, max(f - 1, 1))
        units = [((lrs[0:1],), 0, 1)] if f else []
        units += [((lrs[lo - 1:lo + kc],), lo, min(kc, f - lo)) for lo in range(1, f, kc)]
        sr = None

        def compute(i, frames):
            nonlocal sr
            if i == 0:
                sr = self.model.step(frames)
                return to_uint8(sr)
            outs = []
            for j in range(len(frames) - 1):
                sr = self.model.step(frames[j + 1:j + 2], frames[j:j + 1], sr)
                outs.append(to_uint8(sr))
            return torch.cat(outs)

        return self._pipeline(lrs, units, compute, lrs.shape[1:3], save_path, f - 1)

    def _run(self, read, save_path: str, part: int):
        """One clip, its LR frames [F,h,w,3] float from read(), under the
        clip's spans."""
        with span("predictor.clip") as clip:
            with span("predictor.read"):
                lrs = read()
                padded = lrs if self.model.recurrent else self._edge_pad(lrs)
            if self.model.recurrent:
                clip.count(frames=lrs.shape[0], windows=lrs.shape[0], padded=0)
                return self._run_recurrent(lrs, save_path)
            return self._run_windows(padded, save_path, part, lrs.shape[1:3], clip)

    def test_video_truth(self, path: str, name: str = "result", part: int = 1000):
        """Degrade truth/*.png on the device, then super-resolve."""
        truth = os.path.join(path, "truth")
        return self._run(lambda: self._degrade_video(self._read_video(truth)),
                         os.path.join(path, name), part)

    def test_video_lr(self, path: str, name: str = "result", part: int = 1000):
        """Super-resolve pre-rendered blur{scale}/*.png."""
        blur = os.path.join(path, f"blur{self.scale}")
        return self._run(lambda: self._read_video(blur), os.path.join(path, name), part)

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
