"""Training through the program's `Trainer.fit` over its `TrainPipeline`.

The configuration's "train" states the preset's settings; the traffic's
"train", where it has one, replaces some of them for this mix (batch size,
learning rate), in the program and in the reference alike.

Set-up builds one Trainer (the model with the benchmark's seeded weights,
Adam) and one pipeline over the traffic's seeded in-memory sequences, and
drives them through `fit` for the first steps: step 1 (Adam's state then
gives the first gradient), steps 2-3 (the parameters then give their
change over three steps), then warm-up steps.  The same objects then run
the window: `fit` until the feed, the benchmark's wrapper around the
pipeline, finds the window closed at a step's `get_batch`.  No checkpoint
is saved and nothing is evaluated inside the window.

After the window the reference (benchmark/reference/train.py with the
`train_loss` of benchmark/reference/<model>.py, found by the
configuration's "model" before anything is set up) follows the first three
steps from the batches `fit` received (the feed keeps them) and the same
weights: the first step's loss, the norm of the first gradient and of the
parameters' change after three steps, leaf by leaf (`compare`).
"""

import contextlib
import gc
import io
import shutil
import tempfile
import time
import traceback

import numpy as np
import torch

from benchmark import core, scenes, weights

NEVER = 10 ** 12  # save_every: no checkpoint, no evaluation inside the run
TRAINING = ("train_loss",)  # what the training check calls of a reference module


class WindowClosed(Exception):
    pass


class Feed:
    """The pipeline as `fit` sees it: keeps the first `keep` batches, times
    each get_batch, steps the tracer, and raises once the window is over
    (and, in a traced run, both traced spans are done)."""

    def __init__(self, pipeline, keep: int, tracer=None):
        self.pipeline, self.keep = pipeline, keep
        self.kept, self.waits = [], []
        self.deadline, self.tracer, self.timing = None, tracer, False

    def get_batch(self):
        if (self.deadline is not None and time.perf_counter() >= self.deadline
                and not (self.tracer is not None and self.tracer.pending())):
            raise WindowClosed
        if self.tracer is not None:
            self.tracer.step()
        t = time.perf_counter()
        batch = self.pipeline.get_batch()
        if self.timing:
            self.waits.append(time.perf_counter() - t)
        if len(self.kept) < self.keep:
            self.kept.append(batch)
        return batch


def settings(ctx):
    """The configuration with the traffic's "train" entries over its own."""
    cfg = ctx.config
    return dict(cfg, train={**cfg["train"], **ctx.traffic.get("train", {})})


def sequences(ctx):
    """The traffic's sequences as (frame store, [Sequence])."""
    from pfnl_tpu_torch.data.frames import MemoryFrames
    from pfnl_tpu_torch.data.manifest import Sequence

    t = ctx.traffic
    h, w = t["gt_hw"]
    clips = scenes.make(t["sequences"], t["sequence_frames"], h, w, ctx.sub_seed(1),
                        ctx.device).cpu().numpy()
    frames, seqs = {}, []
    for s in range(clips.shape[0]):
        paths = [f"seq{s}/truth/{k:04d}.png" for k in range(clips.shape[1])]
        frames.update({p: clips[s, k] for k, p in enumerate(paths)})
        seqs.append(Sequence(path=f"seq{s}", truth=paths, blur=[]))
    return MemoryFrames(frames), seqs


def run(ctx):
    from pfnl_tpu_torch.config import preset
    from pfnl_tpu_torch.data.pipeline import TrainPipeline
    from pfnl_tpu_torch.train.trainer import Trainer

    cfg, traffic, dev = settings(ctx), ctx.traffic, ctx.device
    plain = core.reference(cfg, ctx.spec["root"], TRAINING)
    tr = cfg["train"]
    torch.backends.cuda.matmul.allow_tf32 = tr["tf32"]
    torch.backends.cudnn.allow_tf32 = tr["tf32"]
    store, seqs = sequences(ctx)
    ctx.mark("sequences")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    model, w0 = weights.build(cfg, getattr(torch, tr["dtype"]), dev, ctx.sub_seed(2))
    ctx.mark("weights")
    seed = ctx.sub_seed(3) % (2 ** 31)
    workdir = tempfile.mkdtemp(prefix="bench_fit_")  # the Trainer's, never written: no save
    pcfg = preset(tr["preset"], reload=False, seed=seed, save_dir=workdir,
                  batch_size=tr["batch_size"], in_size=tr["in_size"], producer=tr["producer"],
                  learning_rate=tr["learning_rate"], end_lr=tr["end_lr"],
                  decay_power=tr["decay_power"], decay_step=tr["decay_step"],
                  compute_dtype=tr["dtype"], max_step=NEVER)
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        trainer = Trainer(pcfg, workdir=workdir, model=model, device=dev)
    losses = []
    step_fn = trainer.step

    def recording_step(batch, generator):
        out = step_fn(batch, generator)
        if len(losses) < traffic["check_steps"]:
            losses.append(out["loss"].detach().clone())
        return out

    trainer.step = recording_step
    pipe = TrainPipeline(seqs, pcfg.producer, pcfg.num_frames, pcfg.in_size, pcfg.scale,
                         pcfg.batch_size, seed=ctx.sub_seed(4) % (2 ** 31),
                         num_threads=traffic["threads"], prefetch=traffic["prefetch"], source=store)
    tracer = core.Tracer(traffic, ctx.trace)
    feed = Feed(pipe, traffic["check_steps"], tracer)
    names = [n for n, _ in trainer.model.named_parameters()]

    def fit(steps):
        trainer.fit(feed, max_steps=steps, save_every=NEVER, log_every=traffic["log_every"],
                    print_fn=log.write)

    try:
        fit(1)
        opt = trainer.optimizer
        beta1 = opt.param_groups[0]["betas"][0]  # after one step Adam's first moment is (1 - beta1) g
        g1 = {n: (opt.state[p]["exp_avg"] / (1 - beta1)).clone() if p in opt.state
              else torch.zeros_like(p) for n, p in zip(names, trainer.model.parameters())}
        fit(traffic["check_steps"])
        params3 = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        fit(traffic["check_steps"] + traffic["warm_steps"])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ctx.mark("first steps")
        start_step = trainer.global_step
        t0 = time.perf_counter()
        setup_s = t0 - ctx.t_process
        feed.deadline, feed.timing = t0 + ctx.seconds, True
        tracer.start()
        errors = []
        try:
            fit(NEVER)
        except WindowClosed:
            pass
        except Exception:  # noqa: BLE001  (a failing step is counted and reported)
            errors.append(traceback.format_exc()[-2000:])
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        tracer.stop()
    finally:
        pipe.close()
        shutil.rmtree(workdir, ignore_errors=True)
    steps = trainer.global_step - start_step
    memory = torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0
    rec = dict(kind="train", setup_s=setup_s, window_s=t1 - t0, steps=steps,
               attempted=steps + len(errors), failed=len(errors), errors=errors,
               waits_ms=[1e3 * x for x in feed.waits], memory_peak_bytes=memory, config=cfg,
               traffic=traffic, train_batch=pcfg.batch_size, train_in_size=pcfg.in_size,
               **tracer.record())
    prog_losses = [float(v) for v in losses]
    batches = [torch.as_tensor(b["gt"]).to(dev) for b in feed.kept]
    del trainer, model, opt
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    rec["checks"] = compare(plain, cfg, w0, batches, seed, prog_losses, g1, params3,
                            diag=rec.setdefault("diag", {}))
    return rec


def reference(plain, cfg, w0, batches, seed, tf32=False):
    from benchmark.reference import train

    tr = cfg["train"]
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        return train.run(plain, w0, batches, seed, cfg,
                         (tr["learning_rate"], tr["end_lr"], tr["decay_power"],
                          int(tr["decay_step"])))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def compare(plain, cfg, w0, batches, seed, losses, g1, params3, ref=None, diag=None):
    """The numbers `correct` holds, against the reference from the same
    weights and batches: the first step's loss gap relative to the
    reference's loss; leaf by leaf, the gap between the program's and the
    reference's norm of the first gradient, over the larger of the
    reference leaf's norm and the median leaf's, the worst leaf's; and the
    same gap of the parameters' change over the steps, the median leaf's
    (leaves whose reference gradient is under a thousandth of the median
    leaf's left out).  The later steps' loss gaps and the worst leaf's
    change go to `diag`: Adam's first steps move each coordinate by about
    the learning rate whatever its gradient, so float32 round-off in the
    near-zero gradients of a few coordinates moves them apart."""
    ref_losses, ref_g1, ref_p = ref or reference(plain, cfg, w0, batches, seed)
    if len(losses) < len(ref_losses) or not ref_losses:
        return {"first_loss_gap": float("inf"), "grad_gap": float("inf"),
                "median_change_gap": float("inf")}
    gaps = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    names = list(ref_g1)
    gref = {n: float(ref_g1[n].norm()) for n in names}
    gmed = float(np.median(list(gref.values())))
    grad_gap = max(abs(float(g1[n].norm()) - gref[n]) / max(gref[n], gmed) for n in names)
    moved = [n for n in names if gref[n] >= 1e-3 * gmed]
    dref = {n: float((ref_p[n] - w0[n]).norm()) for n in moved}
    dmed = float(np.median(list(dref.values())))
    change = [abs(float((params3[n] - w0[n]).norm()) - dref[n]) / max(dref[n], dmed)
              for n in moved]
    if diag is not None:
        diag.update(loss_gap_by_step=gaps, worst_change_gap=max(change),
                    leaves_left_out=len(names) - len(moved))
    return {"first_loss_gap": gaps[0], "grad_gap": grad_gap,
            "median_change_gap": float(np.median(change))}


def control(ctx, kind="tf32"):
    """The readings of the control, the reference with TF32 on put in the
    program's place (kind "tf32"), or of a fault planted in the reference
    put in its place (kind "half_batch": each step's loss over the first
    half of the batch), against the reference, on the steps the check
    follows (the batches drawn as a run's pipeline draws them)."""
    from pfnl_tpu_torch.config import preset
    from pfnl_tpu_torch.data.pipeline import TrainPipeline

    from benchmark.reference import train

    cfg, traffic, dev = settings(ctx), ctx.traffic, ctx.device
    plain = core.reference(cfg, ctx.spec["root"], TRAINING)
    tr = cfg["train"]
    store, seqs = sequences(ctx)
    _, w0 = weights.build(cfg, torch.float32, dev, ctx.sub_seed(2))
    seed = ctx.sub_seed(3) % (2 ** 31)
    pcfg = preset(tr["preset"], batch_size=tr["batch_size"], in_size=tr["in_size"])
    pipe = TrainPipeline(seqs, tr["producer"], pcfg.num_frames, pcfg.in_size, pcfg.scale,
                         pcfg.batch_size, seed=ctx.sub_seed(4) % (2 ** 31), num_threads=1,
                         prefetch=1, source=store)
    try:
        batches = [torch.as_tensor(pipe.get_batch()["gt"]).to(dev)
                   for _ in range(traffic["check_steps"])]
    finally:
        pipe.close()
    if kind == "tf32":
        got = reference(plain, cfg, w0, batches, seed, tf32=True)
    elif kind == "half_batch":
        full = train.loss_fn

        def half(model, params, gt_u8, f, config):
            b = gt_u8.shape[0] // 2
            return full(model, params, gt_u8[:b], f[:b], config)

        train.loss_fn = half
        try:
            got = reference(plain, cfg, w0, batches, seed)
        finally:
            train.loss_fn = full
    else:
        raise ValueError(f"unknown control {kind!r}")
    diag = {}
    out = compare(plain, cfg, w0, batches, seed, *got, diag=diag)
    out.update(diag)
    return out
