"""Full-size dress rehearsal of the acceptance pipeline on the port
(counterpart: scripts/parity_rehearsal.py): prove that `TF1 checkpoint ->
import-tf1 -> parity` works end to end AT REAL SIZES in one command, so
the authors' real checkpoints + Vid4 become a drop-in.

Stages (each timed):
  1. render a Vid4-SHAPED synthetic dataset: 4 sequences with the real
     Vid4 geometries and frame counts (calendar 41f 576x720, city 34f
     576x704, foliage 49f 480x720, walk 47f 480x720), aliasing-critical
     translating content (truth/ only; the JAX script's scene code and
     random draws);
  2. `python -m pfnl_tpu_torch prepare` renders blur4/ with the
     reference degradation on the device;
  3. an authors'-LAYOUT full-size PFNL TF1 checkpoint (nlvsr scope, 20
     blocks, 7 frames, optimizer slots included), written by
     `utils.tf1_ckpt.save_tf1_checkpoint` (no TensorFlow needed);
  4. `import-tf1 pfnl` converts it to the port's checkpoint;
  5. `parity pfnl` runs full inference over the dataset on the device
     (at Vid4's LR sizes, 5400-6480 non-local positions: on a CUDA device
     kernels 1-4 a forward batch) and prints the README-layout
     Y-PSNR/SSIM table.

Writes PARITY_REHEARSAL_TORCH.md (the table, the stages' seconds, the
device and, on a CUDA device, the kernels' launches in stage 5); the JAX
script's record, PARITY_REHEARSAL.md, is not touched.

The dataset (`--root`) and the checkpoints (`--ckdir`) go under the
temporary directory (`tempfile.gettempdir()`, so $TMPDIR) unless given.
`--root` is the rehearsal's own directory: stage 1 empties it and renders
again unless it holds exactly the sequences asked for, each at its frame
count and size.

Run:        python -m pfnl_tpu_torch.parity_rehearsal [--device cuda]
Small run:  python -m pfnl_tpu_torch.parity_rehearsal --small --device cpu
"""

import argparse
import os
import shutil
import tempfile
import time

import numpy as np
import torch

VID4 = [  # name, frames, H, W  (real Vid4 geometry)
    ("calendar", 41, 576, 720),
    ("city", 34, 576, 704),
    ("foliage", 49, 480, 720),
    ("walk", 47, 480, 720),
]
VID4_SMALL = [(n, 18, 96, 112) for n, _, _, _ in VID4]


def render_dataset(root, seqs, seed=0):
    """Aliasing-critical translating scenes at the given geometries (the
    recipe of convergence.make_rich_dataset, truth/ only: blur4/ comes
    from `prepare` to exercise that stage)."""
    from pfnl_tpu_torch.utils.image_io import imsave

    rng = np.random.default_rng(seed)
    sig = lambda z: 1.0 / (1.0 + np.exp(-np.clip(z, -30, 30)))  # noqa: E731
    for name, nf, h, w in seqs:
        d = os.path.join(root, name, "truth")
        os.makedirs(d, exist_ok=True)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        v_bg = rng.uniform(-1.2, 1.2, 2)
        gfreq = rng.uniform(0.14, 0.26, 3)
        gth = rng.uniform(0, np.pi, 3)
        gsh = rng.uniform(1.5, 3.0, 3)
        nshape = rng.integers(8, 14)
        scx, scy = rng.uniform(0, w, nshape), rng.uniform(0, h, nshape)
        ssz = rng.uniform(8, 40, (nshape, 2))
        scol = rng.uniform(0.05, 0.95, (nshape, 3))
        v_fg = rng.uniform(-1.2, 1.2, 2)
        for t in range(nf):
            bx, by = xx + v_bg[0] * t, yy + v_bg[1] * t
            chans = []
            for c in range(3):
                ph = gfreq[c] * 2 * np.pi * (np.cos(gth[c]) * bx
                                             + np.sin(gth[c]) * by)
                chans.append(0.5 + 0.22 * np.tanh(gsh[c] * np.sin(ph)))
            img = np.stack(chans, -1)
            fx = (xx - v_fg[0] * t) % w
            fy = (yy - v_fg[1] * t) % h
            for i in range(nshape):
                dx = (fx - scx[i] + w / 2) % w - w / 2
                dy = (fy - scy[i] + h / 2) % h - h / 2
                a = (sig(2.5 * (dx + ssz[i, 0] / 2))
                     * sig(2.5 * (ssz[i, 0] / 2 - dx))
                     * sig(2.5 * (dy + ssz[i, 1] / 2))
                     * sig(2.5 * (ssz[i, 1] / 2 - dy)))
                img = img * (1 - a[..., None]) + a[..., None] * scol[i]
            imsave(os.path.join(d, f"{t:04d}.png"),
                   np.round(np.clip(img, 0, 1) * 255).astype(np.uint8))


def truth_matches(root, seqs):
    """Whether `root` holds truth/ of exactly the sequences `seqs` names,
    each with its frame count at its size, and no other sequence."""
    from pfnl_tpu_torch.utils.image_io import imread

    if not os.path.isdir(root):
        return False
    if sorted(os.listdir(root)) != sorted(name for name, _, _, _ in seqs):
        return False
    for name, nf, h, w in seqs:
        d = os.path.join(root, name, "truth")
        frames = sorted(os.listdir(d)) if os.path.isdir(d) else []
        if len(frames) != nf or imread(os.path.join(d, frames[0])).shape != (h, w, 3):
            return False
    return True


def synth_tf1_ckpt(prefix, num_blocks=20, t=7, mf=64, seed=7):
    """Authors'-layout PFNL TF1 checkpoint (reference model/pfnl.py:47-53
    naming) with random weights, the JAX script's names, shapes and draws,
    written by save_tf1_checkpoint; returns the arrays."""
    from pfnl_tpu_torch.utils.tf1_ckpt import save_tf1_checkpoint

    rng = np.random.default_rng(seed)

    def W(*shape, s=0.05):
        return (rng.standard_normal(shape) * s).astype(np.float32)

    cnl = 3 * t * 4
    tf_vars = {
        "nlvsr/nlblock_0/g/g/kernel": W(1, 1, cnl, cnl),
        "nlvsr/nlblock_0/g/g/bias": W(cnl),
        "nlvsr/nlblock_0/w/w/kernel": W(1, 1, cnl, cnl),
        "nlvsr/nlblock_0/w/w/bias": W(cnl),
        "nlvsr/conv0/kernel": W(5, 5, 3, mf),
        "nlvsr/conv0/bias": W(mf),
        "nlvsr/convmerge1/kernel": W(3, 3, t * mf, 48),
        "nlvsr/convmerge1/bias": W(48),
        "nlvsr/convmerge2/kernel": W(3, 3, 12, 12),
        "nlvsr/convmerge2/bias": W(12),
        # the importer must skip optimizer slots + bookkeeping
        "nlvsr/conv0/kernel/Adam": W(5, 5, 3, mf),
        "nlvsr/conv0/kernel/Adam_1": W(5, 5, 3, mf),
        "global_step": np.asarray(150000, np.int64),
    }
    for i in range(num_blocks):
        tf_vars[f"nlvsr/conv1_{i}/kernel"] = W(3, 3, mf, mf)
        tf_vars[f"nlvsr/conv1_{i}/bias"] = W(mf)
        tf_vars[f"nlvsr/conv10_{i}/kernel"] = W(1, 1, t * mf, mf)
        tf_vars[f"nlvsr/conv10_{i}/bias"] = W(mf)
        tf_vars[f"nlvsr/conv2_{i}/kernel"] = W(3, 3, 2 * mf, mf)
        tf_vars[f"nlvsr/conv2_{i}/bias"] = W(mf)
    save_tf1_checkpoint(prefix, tf_vars)
    return tf_vars


def write_record(out, stages, table, seqs, device, launches=None):
    """The rehearsal's record: the stages' seconds, the table, what ran it."""
    from pfnl_tpu_torch.utils.device import device_label

    frames = {name: nf for name, nf, _, _ in seqs}
    geometry = ", ".join(f"{n} {nf}f {h}x{w}" for n, nf, h, w in seqs)
    with open(out, "wt") as f:
        size = "full size" if seqs == VID4 else "small geometry"
        f.write(f"# Parity dress rehearsal (synthetic, {size}), PyTorch port\n\n")
        f.write(
            "The acceptance gate (<=0.01 dB vs the reference's Vid4/UDM10\n"
            "tables, BASELINE.md) needs the authors' checkpoints + real\n"
            "datasets, which the repo lacks.  This rehearsal runs the\n"
            "ENTIRE offline pipeline of the port at real sizes so those\n"
            "become a drop-in: Vid4-geometry synthetic truth -> `prepare`\n"
            "(the reference's blur4) -> authors'-layout TF1 checkpoint\n"
            "(written without TensorFlow) -> `import-tf1 pfnl` -> `parity\n"
            "pfnl` (windowed inference + MATLAB-equivalent Y-PSNR/SSIM\n"
            "table).  Command: `python -m pfnl_tpu_torch.parity_rehearsal`\n"
            f"(pfnl_tpu_torch/parity_rehearsal.py) on {device_label(device)},\n"
            f"torch {torch.__version__}.  Geometry: {geometry}.\n\n")
        f.write("| stage | wall clock |\n|---|---:|\n")
        for name, dt in stages:
            f.write(f"| {name} | {dt:.1f}s |\n")
        if launches:
            f.write("\nKernel launches in stage 5 (`torch.ops.pfnl`): "
                    + ", ".join(f"{k} {v}" for k, v in launches.items() if v) + "\n")
        f.write("\n## Y-channel table (README layout; random weights, "
                "so the numbers only prove the plumbing)\n\n")
        f.write("| sequence | frames | PSNR (dB) | SSIM |\n|---|---:|---:|---:|\n")
        for name, (p, s) in table.items():
            f.write(f"| {name} | {frames.get(name, sum(frames.values()))} | {p:.4f} | "
                    f"{s:.6f} |\n")
        f.write(f"\n```\n{table}\n```\n")
    print(f"wrote {out}", flush=True)


def rehearse(root, ckdir, seqs, device, print_fn=print):
    """The five stages on `device` over `seqs` under `root` (stage 1 only
    where `root` does not hold them already: it empties `root` and
    renders), the checkpoints under `ckdir`; returns (the parity table,
    [(stage, seconds)], the kernels' launches in stage 5 on a CUDA device,
    else None).  A stage's seconds end when the device is done."""
    from pfnl_tpu_torch.__main__ import main as cli

    cuda = torch.device(device).type == "cuda"
    stages = []

    def stage(name, fn):
        if cuda:
            torch.cuda.synchronize(device)
        t0 = time.time()
        out = fn()
        if cuda:
            torch.cuda.synchronize(device)
        dt = time.time() - t0
        stages.append((name, dt))
        print_fn(f"[rehearsal] {name}: {dt:.1f}s")
        return out

    if not truth_matches(root, seqs):
        shutil.rmtree(root, ignore_errors=True)
        stage("1 render Vid4-shaped truth", lambda: render_dataset(root, seqs))
    stage("2 prepare (blur4)", lambda: cli(["prepare", "--root", root, "--no-filelists",
                                            "--device", device]))
    ck = os.path.join(ckdir, "tf1", "pfnl.ckpt")
    stage("3 synth TF1 checkpoint", lambda: synth_tf1_ckpt(ck))
    save_dir = os.path.join(ckdir, "torch")
    stage("4 import-tf1", lambda: cli(["import-tf1", "pfnl", "--ckpt", ck,
                                       "--save-dir", save_dir]))
    launches = None
    if cuda:
        from pfnl_tpu_torch.ops.cuda import KERNELS, launches as counts, reset_launches

        reset_launches()
    table = stage("5 parity", lambda: cli(["parity", "pfnl", "--data", root, "--save-dir",
                                           save_dir, "--name", "rehearsal", "--device",
                                           device]))
    if cuda:
        launches = {k: counts[k] for k in KERNELS}
    return table, stages, launches


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m pfnl_tpu_torch.parity_rehearsal")
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "vid4_shaped_torch"),
                    help="the rehearsal's own dataset directory: emptied and rendered again "
                         "unless it holds exactly the sequences of this geometry")
    ap.add_argument("--ckdir", default=os.path.join(tempfile.gettempdir(), "parity_ck_torch"))
    ap.add_argument("--out", default="PARITY_REHEARSAL_TORCH.md")
    ap.add_argument("--small", action="store_true", help="tiny geometry (96x112, 18 frames)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    seqs = VID4_SMALL if a.small else VID4
    table, stages, launches = rehearse(a.root, a.ckdir, seqs, a.device,
                                       print_fn=lambda m: print(m, flush=True))
    write_record(a.out, stages, table, seqs, a.device, launches)


if __name__ == "__main__":
    main()
