"""ctypes bindings of the port's PNG codec (loader.cc): `png_size`,
`decode_crop_batch` and `encode_png`, as in pfnl_tpu/native/__init__.py.

loader.cc reads and writes PNG over zlib alone (the GPU machines carry
zlib but no libpng, cv2 or PIL).  It is compiled with g++ on first use
into pfnl_tpu_torch/build/libpfnl_png.so, again whenever the source is
newer than the library.  A file lock serialises builds of several
processes (test workers, say); each writes the library under a temporary
name and renames it.  A failed build raises with g++'s message, and a
frame that cannot be decoded raises IOError: nothing falls back to another
codec.  Nothing is built at import.
"""

import ctypes
import fcntl
import os
import subprocess
import threading
import time

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG, "native", "loader.cc")
BUILD = os.path.join(_PKG, "build")
LIB = os.path.join(BUILD, "libpfnl_png.so")
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
LIBS = ["-lz", "-lpthread"]
# pfnl_decode_crop_batch's per-frame status (loader.cc `Status`)
STATUS = {1: "cannot be read", 2: "is not a PNG this codec decodes (or is corrupt)",
          3: "does not hold the window asked for"}

_lib = None
_lib_lock = threading.Lock()


def build(source: str = None, lib: str = None, force: bool = False) -> float:
    """Compile `source` (default SOURCE) into `lib` (default LIB) if it is
    missing or older than the source.  Returns the seconds g++ took (0.0
    when `lib` was up to date); raises RuntimeError with g++'s output when
    the build fails."""
    source, lib = source or SOURCE, lib or LIB
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    with open(lib + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not force and os.path.exists(lib) and (
                os.path.getmtime(lib) >= os.path.getmtime(source)):
            return 0.0
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmd = ["g++", *CXX_FLAGS, source, "-o", tmp, *LIBS]
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
        except FileNotFoundError as e:
            raise RuntimeError(f"the PNG codec needs g++ to build {source}: {e}") from e
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed with code {proc.returncode} building the PNG codec:\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib)
        return time.perf_counter() - t0


def _library():
    global _lib
    with _lib_lock:
        if _lib is None:
            build()
            lib = ctypes.CDLL(LIB)
            lib.pfnl_png_codec.argtypes, lib.pfnl_png_codec.restype = [], ctypes.c_char_p
            c_int_p = ctypes.POINTER(ctypes.c_int)
            lib.pfnl_png_size.argtypes = [ctypes.c_char_p, c_int_p, c_int_p]
            lib.pfnl_png_size.restype = ctypes.c_int
            lib.pfnl_decode_crop_batch.argtypes = [
                ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, c_int_p, c_int_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_ubyte), c_int_p, ctypes.c_int]
            lib.pfnl_decode_crop_batch.restype = ctypes.c_int
            lib.pfnl_encode_png.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte),
                                            ctypes.c_int, ctypes.c_int, ctypes.c_int]
            lib.pfnl_encode_png.restype = ctypes.c_int
            _lib = lib
    return _lib


def codec() -> str:
    """What the library decodes with: "zlib <version>" (builds it first)."""
    return _library().pfnl_png_codec().decode()


def _int_p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int))


def png_size(path: str):
    """(H, W) from the file's header alone; IOError if it is no PNG."""
    h, w = ctypes.c_int(), ctypes.c_int()
    rc = _library().pfnl_png_size(os.fsencode(path), ctypes.byref(h), ctypes.byref(w))
    if rc != 0:
        raise IOError(f"png_size: {path} {STATUS.get(rc, f'failed ({rc})')}")
    return h.value, w.value


def decode_crop_batch(paths, y0=None, x0=None, crop_hw=None, threads: int = 4) -> np.ndarray:
    """Decode `paths` over `threads` threads into one uint8 [N, H, W, 3] RGB
    array.  crop_hw (h, w): frame i is rows y0[i].. and columns x0[i].. of
    its image, which must hold that window; crop_hw None: whole frames, all
    of the first one's size.  IOError names the first frame that failed."""
    lib = _library()
    n = len(paths)
    if crop_hw is None:
        h, w = png_size(paths[0])
        y, x = np.zeros(n, np.int32), np.zeros(n, np.int32)
    else:
        h, w = (int(v) for v in crop_hw)
        y, x = np.asarray(y0, np.int32).reshape(-1), np.asarray(x0, np.int32).reshape(-1)
        if len(y) != n or len(x) != n:
            raise ValueError(f"decode_crop_batch: {n} paths, {len(y)} y0, {len(x)} x0")
    out = np.empty((n, h, w, 3), np.uint8)
    status = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    failures = lib.pfnl_decode_crop_batch(
        c_paths, n, _int_p(y), _int_p(x), h, w, int(crop_hw is not None),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)), _int_p(status), threads)
    if failures:
        i = int(np.flatnonzero(status)[0])
        window = (f"rows {y[i]}..{y[i] + h}, columns {x[i]}..{x[i] + w}" if crop_hw is not None
                  else f"a whole {h}x{w} frame")
        raise IOError(f"decode_crop_batch: {failures}/{n} frames failed; {paths[i]} "
                      f"{STATUS.get(int(status[i]), 'failed')} ({window})")
    return out


def encode_png(path: str, img: np.ndarray) -> None:
    """Write uint8 img, [H, W, 3] RGB or [H, W] gray, as an 8-bit PNG."""
    img = np.ascontiguousarray(img, np.uint8)
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_png takes [H,W,3] or [H,W], got {img.shape}")
    ch = 1 if img.ndim == 2 else 3
    rc = _library().pfnl_encode_png(os.fsencode(path),
                                    img.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
                                    img.shape[0], img.shape[1], ch)
    if rc != 0:
        raise IOError(f"encode_png: writing {path} failed ({rc})")
