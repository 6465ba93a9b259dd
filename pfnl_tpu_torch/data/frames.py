"""Frame stores: where the port reads frames from and writes them to.

`PngFrames` (the default) is PNG files on disk through the port's
utils/image_io.py (cv2, else PIL, else the port's native codec, chosen on
first use; `TrainPipeline` decodes its windows with the native codec).
`MemoryFrames` holds uint8 [H,W,3] frames in a dict keyed by path, for
frames that never touch the disk.  Both offer list(directory), read(path), write(path, img) and
sequences(root), the sequence directories of a dataset directory.
"""

import glob
import os

import numpy as np

from pfnl_tpu_torch.data.manifest import scan_dataset_dir
from pfnl_tpu_torch.utils.image_io import imread, imsave


class PngFrames:
    """PNG frames on disk."""

    @staticmethod
    def list(directory: str):
        return sorted(glob.glob(os.path.join(directory, "*.png")))

    @staticmethod
    def read(path: str) -> np.ndarray:
        return imread(path)

    @staticmethod
    def write(path: str, img: np.ndarray) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        imsave(path, img)

    @staticmethod
    def sequences(root: str):
        return scan_dataset_dir(root)


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

    def sequences(self, root: str):
        """root/<seq> for every <seq> that holds a frame directory."""
        seqs = set()
        for p in self.frames:
            rel = os.path.relpath(p, root)
            if not rel.startswith(".."):
                parts = rel.split(os.sep)
                if len(parts) >= 3:
                    seqs.add(os.path.join(root, parts[0]))
        return sorted(seqs)
