"""Offline parity tables (counterpart: pfnl_tpu/eval/tables.py:22-72), the
analogue of the reference's MATLAB scripts (matlab/compute_psnr.m,
matlab/SSIM.m), which produce the published Vid4/UDM10 tables from saved
result frames.

For every sequence directory under a dataset root, compares
`<seq>/<result_name>/NNNN.png` against `<seq>/truth/NNNN.png` on the
Y channel of the uint8 images and reports per-sequence and average
PSNR/SSIM in the README's table layout.  Frames are read through a frame
store (data/frames.py): PNG files by default, or `MemoryFrames` for
frames held in memory.
"""

import os
from typing import Dict, Tuple

import numpy as np

from pfnl_tpu_torch.data.frames import PngFrames
from pfnl_tpu_torch.eval.metrics import psnr_y_matlab, ssim_y_matlab


def sequence_metrics(seq_dir: str, result_name: str, skip_missing: bool = True,
                     source=None) -> Tuple[float, float, int]:
    """(mean PSNR, mean SSIM, #frames) for one sequence."""
    source = source or PngFrames()
    results = source.list(os.path.join(seq_dir, result_name))
    truths = source.list(os.path.join(seq_dir, "truth"))
    if not results:
        raise FileNotFoundError(f"no results under {seq_dir}/{result_name}")
    psnrs, ssims = [], []
    for rp, tp in zip(results, truths):
        r, t = source.read(rp), source.read(tp)
        if r.shape != t.shape:
            if skip_missing:
                continue
            raise ValueError(f"shape mismatch {rp} vs {tp}")
        psnrs.append(psnr_y_matlab(r, t))
        ssims.append(ssim_y_matlab(r, t))
    return float(np.mean(psnrs)), float(np.mean(ssims)), len(psnrs)


def dataset_table(dataset_root: str, result_name: str, print_fn=print,
                  source=None) -> Dict[str, Tuple[float, float]]:
    """Per-sequence and average PSNR/SSIM over a dataset directory."""
    source = source or PngFrames()
    rows: Dict[str, Tuple[float, float]] = {}
    for seq in source.sequences(dataset_root):
        try:
            p, s, _ = sequence_metrics(seq, result_name, source=source)
        except FileNotFoundError:
            continue
        rows[os.path.basename(seq)] = (p, s)
    if not rows:
        raise FileNotFoundError(f"no '{result_name}' results under {dataset_root}")
    print_fn(f"| Sequence | {result_name} |")
    print_fn("|:---:|:---:|")
    for name, (p, s) in rows.items():
        print_fn(f"| {name} | {p:.2f} / {s:.4f} |")
    avg_p = float(np.mean([p for p, _ in rows.values()]))
    avg_s = float(np.mean([s for _, s in rows.values()]))
    print_fn(f"| **average** | **{avg_p:.2f} / {avg_s:.4f}** |")
    rows["average"] = (avg_p, avg_s)
    return rows
