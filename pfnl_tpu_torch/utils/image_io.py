"""PNG frames on the host, RGB channel order (counterpart:
pfnl_tpu/utils/image_io.py, whose PNGs these are byte for byte where cv2
writes them).

The reference wraps cv2 with BGR<->RGB swaps (utils.py:362-372); so does
this module.  The codec is chosen at each call: cv2, else PIL, else the
port's own zlib codec (native/, built with g++ on first use), the one a
machine with neither cv2 nor PIL has.  Where none of the three is
available, reading or writing raises naming all three.

One difference between the codecs: the native codec and PIL expand a gray
file to RGB [H,W,3], as the JAX package's native loader does, where cv2
returns it [H,W].
"""

import numpy as np


def _cv2():
    try:
        import cv2
    except ImportError as e:
        return None, e
    return cv2, None


def _pil():
    try:
        from PIL import Image
    except ImportError as e:
        return None, e
    return Image, None


def _native():
    """The port's codec, built if need be (a failed build: g++'s message)."""
    from pfnl_tpu_torch import native

    try:
        native.codec()
    except (RuntimeError, OSError) as e:
        return None, e
    return native, None


_FINDERS = {"cv2": _cv2, "PIL": _pil, "native": _native}


def _choose():
    """(name, module) of the first of cv2, PIL and native that is
    available; raises naming the three, with why each failed, where none
    is."""
    tried = []
    for name, find in _FINDERS.items():
        mod, why = find()
        if mod is not None:
            return name, mod
        tried.append(f"{name}: {why}")
    raise RuntimeError("no PNG codec among cv2, PIL and the port's native codec "
                       f"(pfnl_tpu_torch/native): {'; '.join(tried)}")


def codec() -> str:
    """The codec imread and imsave use here: "cv2", "PIL" or "native"."""
    return _choose()[0]


def imread(path: str) -> np.ndarray:
    """uint8 RGB [H,W,3] (through cv2 a grayscale file comes back [H,W])."""
    name, mod = _choose()
    if name == "cv2":
        img = mod.imread(path, mod.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(path)
        return img[:, :, [2, 1, 0]] if img.ndim == 3 else img
    if name == "PIL":
        return np.asarray(mod.open(path).convert("RGB"))
    return mod.decode_crop_batch([path], threads=1)[0]


def imsave(path: str, img: np.ndarray) -> None:
    """Write uint8 img ([H,W,3] RGB or [H,W]) as a PNG; raises where the
    write fails (cv2 would fail without saying so at a missing directory)."""
    img = np.squeeze(img)
    name, mod = _choose()
    if name == "cv2":
        if img.ndim == 3:
            img = img[:, :, [2, 1, 0]]
        if not mod.imwrite(path, img):
            raise IOError(f"imsave failed: {path}")
    elif name == "PIL":
        mod.fromarray(img).save(path)
    else:
        mod.encode_png(path, img)
