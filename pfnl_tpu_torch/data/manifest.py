"""Dataset directories (counterpart: pfnl_tpu/data/manifest.py, whose
package import loads jax, hence this copy).  A dataset directory holds one
subdirectory per sequence, each with `truth/*.png` and `blur{scale}/*.png`.
"""

import glob
import os
from typing import List


def scan_dataset_dir(path: str) -> List[str]:
    """Sorted sequence subdirectories of a dataset dir
    (reference model/pfnl.py:323-324)."""
    kinds = sorted(glob.glob(os.path.join(path, "*")))
    return [k for k in kinds if os.path.isdir(k)]
