"""Dataset manifests (counterpart: pfnl_tpu/data/manifest.py, whose
package import loads jax, hence this copy).

Dataset layout contract (reference model/base_model.py:132-139): a filelist
is a newline-separated list of sequence directories; each directory holds
`truth/*.png` (HR ground truth) and `blur{scale}/*.png` (pre-rendered LR).
A dataset directory holds one such subdirectory per sequence.
"""

import dataclasses
import glob
import os
from typing import List


@dataclasses.dataclass
class Sequence:
    path: str
    truth: List[str]
    blur: List[str]

    @property
    def name(self) -> str:
        return os.path.basename(os.path.normpath(self.path))


def load_manifest(filelist: str, scale: int = 4, need_blur: bool = False) -> List[Sequence]:
    with open(filelist, "rt") as f:
        dirs = [line for line in f.read().splitlines() if line.strip()]
    seqs = []
    for d in dirs:
        truth = sorted(glob.glob(os.path.join(d, "truth", "*.png")))
        blur = sorted(glob.glob(os.path.join(d, f"blur{scale}", "*.png")))
        if need_blur and not blur:
            raise FileNotFoundError(f"no blur{scale}/*.png under {d}")
        seqs.append(Sequence(path=d, truth=truth, blur=blur))
    return seqs


def scan_dataset_dir(path: str) -> List[str]:
    """Sorted sequence subdirectories of a dataset dir
    (reference model/pfnl.py:323-324)."""
    kinds = sorted(glob.glob(os.path.join(path, "*")))
    return [k for k in kinds if os.path.isdir(k)]
