"""PNG frames on the host, RGB channel order (counterpart:
pfnl_tpu/utils/image_io.py, whose PNGs these are byte for byte).

The reference wraps cv2 with BGR<->RGB swaps (utils.py:362-372); so does
this module.  cv2, or PIL where cv2 is missing, is imported on first use,
so machines with neither can import the port.
"""

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def imread(path: str) -> np.ndarray:
    """uint8 RGB [H,W,3] (a grayscale file comes back [H,W])."""
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(path)
        return img[:, :, [2, 1, 0]] if img.ndim == 3 else img
    from PIL import Image

    return np.asarray(Image.open(path).convert("RGB"))


def imsave(path: str, img: np.ndarray) -> None:
    """Write uint8 img ([H,W,3] RGB or [H,W]) as a PNG; raises where cv2
    fails without saying so (a missing directory, say)."""
    img = np.squeeze(img)
    cv2 = _cv2()
    if cv2 is not None:
        if img.ndim == 3:
            img = img[:, :, [2, 1, 0]]
        if not cv2.imwrite(path, img):
            raise IOError(f"imsave failed: {path}")
        return
    from PIL import Image

    Image.fromarray(img).save(path)
