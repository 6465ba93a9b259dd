"""Convergence evidence on the port (counterpart: scripts/convergence.py):
train every model family on rich synthetic data and record the eval-PSNR
curve beside single-frame bicubic under the same protocol.

Synthetic sequences are multi-octave textures translating with per-channel
velocities, 20 frames, so both the training producers and the evaluator
protocol (center=15, stride 32) operate as on real data.  Each family
trains `--steps` steps at its preset with the periodic Evaluator on the
port's Trainer (on a CUDA device its kernels: PFNL K2-K6, the flow
families K7 or K8 under autograd, DUF K9 in the evaluations); the PSNR
curve is parsed from the eval log and written to the report together with
two mechanism checks:

  * staged switch (VESPCN, LTDVSR, MCResNet, DRVSR): the flow subnet is
    frozen during stage 0 and starts moving after `stage_switch_step`
    (fresh stage-1 Adam state);
  * DRVSR's LSTM-only clip_by_global_norm(3) selects parameters.

Run:  python -m pfnl_tpu_torch.convergence --steps 2000
      [--models pfnl ...] [--assemble-only] [--device cuda]

It writes CONVERGENCE_TORCH.md; the JAX script's record, CONVERGENCE.md,
is not touched.  The scenes (`--root`) and the logs (`--workroot`) go under
the temporary directory (`tempfile.gettempdir()`, so $TMPDIR) unless given;
scenes found there are used again only where they are the full set at its
size.  The families can run one call at a time (`--models`) and the report
be rebuilt from the logs under `--workroot` (`--assemble-only`).  Training
and evaluation run in full float32: TF32 is off inside `run_family`.
"""

import argparse
import contextlib
import json
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from pfnl_tpu_torch.utils.device import device_label, tf32_off

MODELS = ["pfnl", "vespcn", "ltdvsr", "mcresnet", "drvsr", "frvsr", "duf"]


def _load_json(path):
    """Tolerate a missing or truncated (interrupted-write) JSON file."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _dump_json(path, obj):
    """Atomic replace: an interrupted write must not lose the sweep record."""
    with open(path + ".tmp", "wt") as f:
        json.dump(obj, f)
    os.replace(path + ".tmp", path)


def make_rich_dataset(root, num_seqs=24, num_frames=20, hw=(160, 256), seed=0):
    """Aliasing-critical translating scenes: content with energy ABOVE the
    x4-downsample Nyquist so bicubic upscaling clearly loses and temporal
    fusion of sub-pixel-shifted frames genuinely helps.  Per sequence:

      * background: tanh-sharpened (square-wave-like) gratings at HR
        frequencies 0.14-0.26 cyc/px (LR Nyquist after x4 is 0.125);
      * foreground: sharp-edged (sigmoid k=2.5, ~1 px) random rectangles
        and discs moving with a DIFFERENT velocity (parallax for the
        flow nets);
      * a thin-line grid (2 px period structures).

    All layers are analytic in (x, y), sampled at (x + v*t): exact
    sub-pixel translation.  The scene code and its random draws are the
    JAX script's, in the same order.  Renders truth/ and blur4/ (the
    reference degradation, ops.degrade.downsample_4d on the CPU) and writes
    train/val filelists."""
    from pfnl_tpu_torch.ops.degrade import downsample_4d
    from pfnl_tpu_torch.utils.image_io import imsave

    rng = np.random.default_rng(seed)
    h, w = hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    seq_dirs = []
    sig = lambda z: 1.0 / (1.0 + np.exp(-np.clip(z, -30, 30)))  # noqa: E731
    for s in range(num_seqs):
        d = os.path.join(root, f"seq_{s:03d}")
        os.makedirs(os.path.join(d, "truth"), exist_ok=True)
        os.makedirs(os.path.join(d, "blur4"), exist_ok=True)
        v_bg = rng.uniform(-2, 2, 2) + rng.choice([-0.25, 0.25, 0.5], 2)
        v_fg = rng.uniform(-2, 2, 2) + rng.choice([-0.25, 0.25, 0.5], 2)
        # background gratings (per channel: freq, orientation, sharpness) in
        # 0.14-0.26 cyc/px HR: above the LR Nyquist, where the degradation's
        # sigma=1.6 Gaussian still passes 4-30% of the energy
        gfreq = rng.uniform(0.14, 0.26, 3)
        gth = rng.uniform(0, np.pi, 3)
        gsh = rng.uniform(1.5, 3.0, 3)
        # foreground shapes
        nshape = rng.integers(6, 11)
        scx = rng.uniform(0, w, nshape)
        scy = rng.uniform(0, h, nshape)
        ssz = rng.uniform(6, 28, (nshape, 2))
        scol = rng.uniform(0.05, 0.95, (nshape, 3))
        sdisc = rng.random(nshape) < 0.4
        # thin-line grid
        lper = rng.integers(9, 16)
        frames = []
        for t in range(num_frames):
            bx, by = xx + v_bg[0] * t, yy + v_bg[1] * t
            chans = []
            for c in range(3):
                ph = gfreq[c] * 2 * np.pi * (np.cos(gth[c]) * bx
                                             + np.sin(gth[c]) * by)
                chans.append(0.5 + 0.22 * np.tanh(gsh[c] * np.sin(ph)))
            img = np.stack(chans, -1)
            # thin lines ride the background motion
            lines = sig(2.5 * (np.sin(2 * np.pi * bx / lper) - 0.9)) \
                + sig(2.5 * (np.sin(2 * np.pi * by / lper) - 0.9))
            img = img * (1 - 0.8 * np.clip(lines, 0, 1)[..., None])
            # foreground shapes (wrap-around translation, own velocity)
            fx = (xx - v_fg[0] * t) % w
            fy = (yy - v_fg[1] * t) % h
            for i in range(nshape):
                dx = (fx - scx[i] + w / 2) % w - w / 2
                dy = (fy - scy[i] + h / 2) % h - h / 2
                if sdisc[i]:
                    rr = np.sqrt(dx ** 2 + dy ** 2)
                    a = sig(2.5 * (ssz[i, 0] / 2 - rr))
                else:
                    a = (sig(2.5 * (dx + ssz[i, 0] / 2))
                         * sig(2.5 * (ssz[i, 0] / 2 - dx))
                         * sig(2.5 * (dy + ssz[i, 1] / 2))
                         * sig(2.5 * (ssz[i, 1] / 2 - dy)))
                img = img * (1 - a[..., None]) + a[..., None] * scol[i]
            img = np.clip(img, 0, 1).astype(np.float32)
            frames.append(img)
            imsave(os.path.join(d, "truth", f"{t:04d}.png"),
                   np.round(img * 255).astype(np.uint8))
        with torch.no_grad():
            lr = downsample_4d(torch.from_numpy(np.stack(frames)), scale=4).numpy()
        for t in range(num_frames):
            imsave(os.path.join(d, "blur4", f"{t:04d}.png"),
                   np.round(np.clip(lr[t], 0, 1) * 255).astype(np.uint8))
        seq_dirs.append(d)
    ntrain = max(1, num_seqs - max(2, num_seqs // 8))
    train_list = os.path.join(root, "filelist_train.txt")
    val_list = os.path.join(root, "filelist_val.txt")
    with open(train_list, "wt") as f:
        f.write("\n".join(seq_dirs[:ntrain]) + "\n")
    with open(val_list, "wt") as f:
        f.write("\n".join(seq_dirs[ntrain:]) + "\n")
    return train_list, val_list


def dataset_matches(root, num_seqs=24, num_frames=20, hw=(160, 256)):
    """Whether `root` holds what make_rich_dataset(root, num_seqs,
    num_frames, hw) writes: both filelists, listing `num_seqs` sequences of
    `num_frames` truth/ and blur4/ frames, truth at `hw`."""
    from pfnl_tpu_torch.utils.image_io import imread

    lists = [os.path.join(root, f"filelist_{s}.txt") for s in ("train", "val")]
    if not all(os.path.exists(p) for p in lists):
        return False
    seq_dirs = []
    for p in lists:
        with open(p) as f:
            seq_dirs += f.read().split()
    if len(seq_dirs) != num_seqs:
        return False
    for d in seq_dirs:
        frames = {sub: sorted(os.listdir(os.path.join(d, sub)))
                  if os.path.isdir(os.path.join(d, sub)) else [] for sub in ("truth", "blur4")}
        if any(len(f) != num_frames for f in frames.values()):
            return False
        if imread(os.path.join(d, "truth", frames["truth"][0])).shape[:2] != tuple(hw):
            return False
    return True


def bicubic_baseline(ev, cfg):
    """Bicubic-upscale PSNR under the SAME eval protocol/metric the
    family's evaluator uses (its windows, crops and mse), on the CPU: the
    single-frame-interpolation floor the trained model must beat for the
    curve to demonstrate learning."""
    from pfnl_tpu_torch.ops.color import rgb2y
    from pfnl_tpu_torch.ops.degrade import downsample
    from pfnl_tpu_torch.ops.resize import resize_bicubic

    fam, t = ev.family, cfg.num_frames
    as_tensor = torch.from_numpy
    mses = []
    with torch.no_grad():
        for lr, gt in ev._windows():
            if fam == "pfnl":
                lrw = downsample(as_tensor(gt[None]), scale=cfg.scale)[0]
                bic = resize_bicubic(lrw[t // 2][None], ev.out_hw)[0].numpy()
                mses.append(np.mean((bic - gt[t // 2]) ** 2))
            elif fam == "vespcn":
                lr_y = rgb2y(as_tensor(lr[t // 2][None]))
                gt_y = rgb2y(as_tensor(gt[0][None]))[0].numpy()
                bic = resize_bicubic(lr_y, ev.out_hw)[0].numpy()
                mses.append(np.mean((bic - gt_y) ** 2))
            elif fam == "frvsr":
                bic = resize_bicubic(as_tensor(lr), ev.out_hw).numpy()
                mses.append(np.mean((bic - gt) ** 2))
            else:  # duf
                bic = resize_bicubic(as_tensor(lr[t // 2][None]), ev.out_hw)[0].numpy()
                mses.append(np.mean((bic - gt[0]) ** 2))
    return float(10 * np.log10(1.0 / np.mean(mses)))


def _curve(log_path):
    """[(step, mean PSNR)] of an eval log."""
    curve = []
    with open(log_path) as f:
        for line in f:
            rec = json.loads(line.replace(" ,", ","))
            curve.append((rec["Iter"], float(np.mean(rec["PSNR"]))))
    return curve


def run_family(model, train_list, val_list, steps, eval_every, workroot,
               easyflow_handoff=False, device="cuda"):
    """Train one family for `steps` steps on `device` with the periodic
    Evaluator every `eval_every`, in full float32 (TF32 off inside);
    returns (curve, checks, wall seconds, the trainer's global step).

    easyflow_handoff: pretrain EasyFlow standalone (self-supervised, on
    the LR frames) and restore it into the SR model before training: the
    reference's own EASYFLOW -> load_easyflow workflow
    (modules/model_easyflow.py:131-240).  Without it, stage 0 trains the
    SR trunk against warps from a FROZEN RANDOM flow net."""
    from pfnl_tpu_torch.config import preset
    from pfnl_tpu_torch.data.manifest import load_manifest
    from pfnl_tpu_torch.data.pipeline import TrainPipeline
    from pfnl_tpu_torch.eval.evaluator import Evaluator
    from pfnl_tpu_torch.train.trainer import Trainer, is_flow_param

    over = dict(train_list=train_list, eval_list=val_list, reload=False,
                eval_in_size=(32, 56), eval_batch_size=2,
                save_dir=os.path.join(workroot, model))
    if model == "drvsr":
        over["in_size"] = 32   # reference LR crop is 100; smaller here so
        over["batch_size"] = 4  # the synthetic frames (160x256) suffice
    # the reference's polynomial LR schedule compressed to the run length
    # (its decay_step=1.2e5 would leave the LR near 1e-3 throughout); FRVSR's
    # flat-lr preset (end_lr == learning_rate) is unaffected
    over["decay_step"] = float(steps)
    over["max_step"] = steps + 1
    cfg = preset(model, **over)
    # stage engagement within the short run
    staged = cfg.stage_switch_step is not None
    if staged:
        cfg = preset(model, stage_switch_step=steps // 2, **over)
    os.makedirs(workroot, exist_ok=True)
    log_path = os.path.join(workroot, f"{model}.txt")
    if os.path.exists(log_path):
        os.remove(log_path)

    tr = Trainer(cfg, device=device)
    seqs = load_manifest(cfg.train_list, cfg.scale, need_blur=cfg.producer != "single")
    pipe = TrainPipeline(seqs, cfg.producer, cfg.num_frames, cfg.in_size, cfg.scale,
                         cfg.batch_size, seed=cfg.seed, num_threads=2, prefetch=4)
    with contextlib.closing(pipe), tf32_off():
        ev = Evaluator(cfg, tr.model)
        checks = {}
        if easyflow_handoff:
            from pfnl_tpu_torch.train.easyflow_trainer import (EasyFlowTrainer,
                                                               restore_easyflow_params)

            flow_dir = os.path.join(workroot, f"{model}_easyflow")
            hsteps = max(steps // 5, min(500, steps))
            ft = EasyFlowTrainer(train_list=train_list, save_dir=flow_dir,
                                 num_frames=cfg.num_frames, crop_size=24, batch_size=16,
                                 subdir=f"blur{cfg.scale}", seed=cfg.seed, device=device)
            ft.train(max_steps=hsteps, print_fn=lambda *a: None, save_every=hsteps,
                     summary_every=10 ** 9, image_summary_every=0)
            restore_easyflow_params(flow_dir, tr.model)
            checks["easyflow_pretrained"] = True

        bl_path = os.path.join(workroot, "baselines.json")
        baselines = _load_json(bl_path)
        baselines[model] = bicubic_baseline(ev, cfg)
        _dump_json(bl_path, baselines)

        flow_name = next((n for n, _ in tr.model.named_parameters() if is_flow_param(n)), None)
        flow_snap = {}

        def eval_fn(trainer, step):
            ev.run(step, log_path=log_path, print_fn=lambda *a: None)
            if staged and flow_name is not None:
                flow_snap[step] = trainer.model.get_parameter(flow_name).detach().cpu().clone()

        t0 = time.time()
        tr.fit(pipe, max_steps=steps, eval_fn=eval_fn, save_every=eval_every,
               print_fn=lambda *a: None)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.time() - t0

    curve = _curve(log_path)
    if staged:
        s0 = sorted(k for k in flow_snap if k <= cfg.stage_switch_step)
        s1 = sorted(k for k in flow_snap if k > cfg.stage_switch_step)
        if len(s0) >= 2:
            checks["flow_frozen_stage0"] = bool(torch.equal(flow_snap[s0[0]], flow_snap[s0[-1]]))
        if s0 and s1:
            checks["flow_moves_stage1"] = not torch.equal(flow_snap[s0[-1]], flow_snap[s1[-1]])
    if model == "drvsr":
        # the LSTM-only clip must actually select parameters
        checks["lstm_clip_selects_params"] = bool(tr.clipped)
    ck_path = os.path.join(workroot, "checks.json")
    all_checks = _load_json(ck_path)
    all_checks[model] = dict(checks, steps=steps)
    _dump_json(ck_path, all_checks)
    runs_path = os.path.join(workroot, "runs.json")
    runs = _load_json(runs_path)
    runs[model] = dict(device=device_label(device), wall_s=wall, steps=tr.global_step)
    _dump_json(runs_path, runs)
    return curve, checks, wall, tr.global_step


def assemble(workroot, out, steps, note=""):
    """Rebuild the report from the per-model eval logs (usable after a
    partially-completed sweep).  The tables and delta lines are the JAX
    script's; the header names this module and what ran each family
    (runs.json: the device, the wall seconds of its training and evals)."""
    results = {}
    for m in MODELS:
        log_path = os.path.join(workroot, f"{m}.txt")
        if not os.path.exists(log_path):
            continue
        curve = _curve(log_path)
        if curve:
            results[m] = curve
    baselines = _load_json(os.path.join(workroot, "baselines.json"))
    all_checks = _load_json(os.path.join(workroot, "checks.json"))
    runs = _load_json(os.path.join(workroot, "runs.json"))
    ck_lines = [
        f"{m} ({c.pop('steps', '?')} steps) checks: {c}"
        for m, c in all_checks.items() if c.keys() - {"steps"}
    ]
    if ck_lines:
        note = note + "\n" + "\n".join(ck_lines)
    devices = sorted({r["device"] for m, r in runs.items() if m in results})
    where = " and ".join(devices) if devices else "an unrecorded device"
    run_lines = [f"{m}: {r['steps']} steps in {r['wall_s']:.1f} s of training and evals "
                 f"({r['steps'] / r['wall_s']:.2f} steps/s) on {r['device']}"
                 for m, r in runs.items() if m in results and r["wall_s"] > 0]
    with open(out, "wt") as f:
        f.write("# Convergence evidence (synthetic data), PyTorch port\n\n")
        f.write(
            "Each family trained with its reference preset (DRVSR at a\n"
            "reduced LR crop 32/batch 4 so 160x256 synthetic frames\n"
            "suffice; staged models switch at steps/2 to exercise stage 1),\n"
            "in float32 with TF32 off (`run_family`),\n"
            f"for up to {steps} steps on aliasing-critical translating\n"
            "scenes: sharpened gratings above the x4-downsample Nyquist,\n"
            "sharp-edged parallax shapes, thin-line grids, all with exact\n"
            "sub-pixel motion (`python -m pfnl_tpu_torch.convergence`,\n"
            f"pfnl_tpu_torch/convergence.py, on {where}).\n"
            "Eval protocol: center=15/stride-32 windows, 32x56 LR crops,\n"
            "PSNR on the family's eval metric: the reference's\n"
            "training-log metric, NOT the MATLAB table metric.  The\n"
            "'bicubic' row is single-frame bicubic upscaling under the\n"
            "SAME protocol: the floor a learning model must beat.\n"
            + ("\n" + "\n".join(run_lines) + "\n" if run_lines else "")
            + note + "\n\n")
        for m, curve in results.items():
            f.write(f"## {m}\n\n")
            if m in baselines:
                f.write(f"bicubic baseline: {baselines[m]:.2f} dB\n\n")
            f.write("| step | eval PSNR (dB) |\n|---:|---:|\n")
            for st, p in curve:
                f.write(f"| {st} | {p:.2f} |\n")
            finite = [(st, p) for st, p in curve if np.isfinite(p) and p > -100]
            if finite:
                f.write(f"\ndelta: {finite[-1][1] - finite[0][1]:+.2f} dB "
                        f"(step {finite[0][0]} -> {finite[-1][0]})")
                if m in baselines:
                    f.write(f"; vs bicubic {finite[-1][1] - baselines[m]:+.2f} dB")
                f.write("\n\n")
    print(f"wrote {out} ({len(results)} families)", flush=True)
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m pfnl_tpu_torch.convergence")
    ap.add_argument("--steps", type=int, default=2000)
    ap.add_argument("--eval-every", type=int, default=250)
    ap.add_argument("--models", nargs="*", default=MODELS)
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "conv_ds_torch"))
    ap.add_argument("--workroot",
                    default=os.path.join(tempfile.gettempdir(), "conv_runs_torch"))
    ap.add_argument("--out", default="CONVERGENCE_TORCH.md")
    ap.add_argument("--assemble-only", action="store_true")
    ap.add_argument("--easyflow-handoff", action="store_true",
                    help="pretrain EasyFlow standalone and restore it into "
                         "the EasyFlow-using families before SR training "
                         "(the reference's load_easyflow workflow)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    if a.assemble_only:
        assemble(a.workroot, a.out, a.steps)
        return

    if not dataset_matches(a.root):
        shutil.rmtree(a.root, ignore_errors=True)
        os.makedirs(a.root, exist_ok=True)
        print("generating synthetic dataset ...", flush=True)
        make_rich_dataset(a.root)
    train_list = os.path.join(a.root, "filelist_train.txt")
    val_list = os.path.join(a.root, "filelist_val.txt")
    os.makedirs(a.workroot, exist_ok=True)

    results = {}
    for m in a.models:
        print(f"=== {m}: {a.steps} steps ===", flush=True)
        try:
            curve, checks, wall, step = run_family(
                m, train_list, val_list, a.steps, a.eval_every, a.workroot,
                easyflow_handoff=(a.easyflow_handoff
                                  and m in ("vespcn", "mcresnet", "drvsr")),
                device=a.device)
            results[m] = dict(curve=curve, checks=checks, wall=wall, step=step)
            print(f"{m}: {curve} checks={checks} ({wall:.0f}s)", flush=True)
        except Exception as e:  # the sweep goes on; the report names the failure
            import traceback
            traceback.print_exc()
            results[m] = dict(error=str(e)[:300])

    notes = [f"{m} FAILED: {r['error']}" for m, r in results.items() if "error" in r]
    assemble(a.workroot, a.out, a.steps,
             note="\n" + "\n".join(notes) if notes else "")


if __name__ == "__main__":
    main()
