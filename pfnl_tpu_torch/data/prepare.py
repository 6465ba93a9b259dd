"""Dataset preparation (counterpart: pfnl_tpu/data/prepare.py:26-111).

The reference ships pre-rendered LR frames (`blur4/`) next to the ground
truth (`truth/`) in every sequence directory (model/base_model.py:132-139)
but no script to produce them.  This module renders `blur{scale}/` with
the port's degradation (13x13 Gaussian sigma=1.6, REFLECT pad, depthwise
stride-`scale` conv, ops/degrade.py) on the device, rounded as
round(clip(x*255)), and writes train/val filelists of a dataset root, so
that a truth-only dataset can be trained on and served in one command:

    python -m pfnl_tpu_torch prepare --root /data/mm522
    python -m pfnl_tpu_torch train pfnl --train-list /data/mm522/filelist_train.txt
    python -m pfnl_tpu_torch parity frvsr --data /data/vid4 --save-dir ckpt/frvsr
"""

import glob
import os
from typing import List, Optional, Tuple

import numpy as np
import torch

from pfnl_tpu_torch.ops.degrade import downsample_4d
from pfnl_tpu_torch.utils.image_io import imread, imsave


def render_blur(seq_dir: str, scale: int = 4, batch: int = 8, overwrite: bool = False,
                device="cuda") -> int:
    """Render `blur{scale}/*.png` from `truth/*.png` for one sequence, in
    batches of `batch` frames on `device`.  Returns the number of frames
    written."""
    truths = sorted(glob.glob(os.path.join(seq_dir, "truth", "*.png")))
    if not truths:
        return 0
    out_dir = os.path.join(seq_dir, f"blur{scale}")
    os.makedirs(out_dir, exist_ok=True)
    written = 0
    for i in range(0, len(truths), batch):
        chunk = truths[i:i + batch]
        outs = [os.path.join(out_dir, os.path.basename(p)) for p in chunk]
        if not overwrite and all(os.path.exists(o) for o in outs):
            continue
        imgs = np.stack([imread(p) for p in chunk]).astype(np.float32) / 255.0
        with torch.inference_mode():
            lr = downsample_4d(torch.from_numpy(imgs).to(device), scale=scale)
            lr = torch.round(torch.clamp(lr * 255.0, 0, 255)).to(torch.uint8).cpu().numpy()
        for o, img in zip(outs, lr):
            imsave(o, img)
            written += 1
    return written


def prepare_dataset(root: str, scale: int = 4, overwrite: bool = False, print_fn=print,
                    device="cuda") -> int:
    """Render LR for every sequence directory under `root` (either a flat
    dataset dir of sequences or the MM522 train/<group>/<seq> nesting)."""
    total = 0
    for seq in _iter_sequence_dirs(root):
        n = render_blur(seq, scale=scale, overwrite=overwrite, device=device)
        if n:
            print_fn(f"{seq}: {n} LR frames -> blur{scale}/")
        total += n
    return total


def _iter_sequence_dirs(root: str) -> List[str]:
    """Sequence dirs = directories containing a truth/ subdir, searched up
    to two levels deep (covers both Vid4-style flat and MM522 nesting)."""
    seqs = []
    for cand in sorted(glob.glob(os.path.join(root, "*"))) + sorted(
            glob.glob(os.path.join(root, "*", "*"))):
        if os.path.isdir(os.path.join(cand, "truth")):
            seqs.append(cand)
    return seqs


def make_filelists(root: str, val_count: int = 19, out_train: Optional[str] = None,
                   out_val: Optional[str] = None, print_fn=print) -> Tuple[str, str]:
    """Write filelist_train.txt / filelist_val.txt under `root`.

    The reference's split (data/filelist_train.txt: 521 train seqs,
    filelist_val.txt: 19 val seqs named val_NNN) keeps directories whose
    name starts with 'val' for validation when present; otherwise the
    LAST `val_count` sequences (sorted) become the validation split."""
    seqs = _iter_sequence_dirs(root)
    if not seqs:
        raise FileNotFoundError(f"no sequence dirs (with truth/) under {root}")
    vals = [s for s in seqs if os.path.basename(s).startswith("val")]
    if vals:
        trains = [s for s in seqs if s not in vals]
    else:
        # clamp so small datasets still get a DISJOINT split (a val_count
        # >= len(seqs) would otherwise leak every val sequence into train)
        vc = min(val_count, max(1, len(seqs) // 5)) if len(seqs) <= val_count else val_count
        trains, vals = seqs[:-vc], seqs[-vc:]
        if not trains:
            raise ValueError(f"only {len(seqs)} sequence(s) under {root} — too few for a "
                             "disjoint train/val split")
    out_train = out_train or os.path.join(root, "filelist_train.txt")
    out_val = out_val or os.path.join(root, "filelist_val.txt")
    with open(out_train, "wt") as f:
        f.write("\n".join(trains) + "\n")
    with open(out_val, "wt") as f:
        f.write("\n".join(vals) + "\n")
    print_fn(f"{out_train}: {len(trains)} sequences")
    print_fn(f"{out_val}: {len(vals)} sequences")
    return out_train, out_val
