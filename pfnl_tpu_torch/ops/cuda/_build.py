"""Build, load and call the port's CUDA kernels.

Every `csrc/*.cu` is compiled by `nvcc` into ONE shared library with a
plain C interface, `build/libpfnl_kernels.so`, on first use, and loaded
with ctypes (no PyTorch headers are compiled, so a build takes seconds).
A file lock serialises concurrent builds; the library is rebuilt when any
source is newer than it.  A failed build raises.  The `-Xptxas -v` report
(registers, shared memory, spills per kernel) is kept beside the library
in `build/ptxas.txt`.

Nothing here runs at import: the CPU tests import every module of the
port on machines without nvcc or a GPU.
"""

import collections
import ctypes
import fcntl
import glob
import os
import shutil
import subprocess
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
LIB = os.path.join(BUILD, "libpfnl_kernels.so")
PTXAS_LOG = os.path.join(BUILD, "ptxas.txt")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Kernel launches per kernel name, bumped by each wrapper where it launches
# its kernel (never on the plain CPU path).
launches = collections.Counter()

_lib = None


def reset_launches():
    launches.clear()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    path = shutil.which("nvcc")
    if path is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return path


def sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _stale() -> bool:
    if not os.path.exists(LIB):
        return True
    deps = sources() + glob.glob(os.path.join(CSRC, "*.cuh"))
    return max(os.path.getmtime(p) for p in deps) > os.path.getmtime(LIB)


def build(force: bool = False) -> float:
    """Compile the library if it is missing or older than a source.
    Returns the seconds nvcc took (0.0 when the library was up to date)."""
    os.makedirs(BUILD, exist_ok=True)
    with open(os.path.join(BUILD, ".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (force or _stale()):
            return 0.0
        tmp = f"{LIB}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources()]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        with open(PTXAS_LOG, "w") as f:
            f.write(proc.stdout + proc.stderr)
        os.replace(tmp, LIB)
        return seconds


def _library():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(LIB)
        lib.pfnl_cuda_error_string.argtypes = [ctypes.c_int]
        lib.pfnl_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def call(name: str, *args):
    """Call C entry `name` with device pointers and ints as given, then
    the current stream of the first tensor's device, with that device
    current; raise if it reports a CUDA error.  `args` holds tensors
    (passed as pointers) and Python ints, in the entry's order; the
    caller keeps every tensor alive until this returns (the launch is
    stream-ordered after that, so the caching allocator may then reuse
    the memory safely)."""
    lib = _library()
    fn = getattr(lib, name)
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p if isinstance(a, torch.Tensor) else ctypes.c_int
                       for a in args] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    values = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    device = next(a.device for a in args if isinstance(a, torch.Tensor))
    with torch.cuda.device(device):
        err = fn(*values, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        msg = lib.pfnl_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def suffix(dtype: torch.dtype) -> str:
    """C entry suffix for an activation dtype; raises for any other."""
    if dtype == torch.float32:
        return "f32"
    if dtype == torch.bfloat16:
        return "bf16"
    raise TypeError(f"kernels take float32 or bfloat16 activations, got {dtype}")


def check_cuda_inputs(name: str, *tensors):
    """Every tensor on one CUDA device and contiguous; raises otherwise."""
    dev = tensors[0].device
    for x in tensors:
        if x.device != dev or x.device.type != "cuda":
            raise ValueError(f"{name}: all inputs must be on one CUDA device, "
                             f"got {[str(t.device) for t in tensors]}")
        if not x.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def weight_f32(w: torch.Tensor, dtype: torch.dtype, device) -> torch.Tensor:
    """A parameter rounded to the activation dtype (as the plain version
    casts it at use), then held as contiguous float32 for the kernel."""
    return w.detach().to(device=device, dtype=dtype).float().contiguous()
