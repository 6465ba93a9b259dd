"""Build, load and call the port's CUDA kernels.

Every `csrc/*.cu` is compiled by its own `nvcc` process, all started
together, into an object file under `build/obj/`; one more `nvcc` links
them into ONE shared library with a plain C interface,
`build/libpfnl_kernels.so`, on first use, loaded with ctypes (no PyTorch
headers are compiled, so a build takes seconds).  A file lock serialises
concurrent builds; the library is rebuilt when any source is newer than
it.  A failed build raises.  The `-Xptxas -v` report (registers, shared
memory, spills per kernel) is kept beside the library in
`build/ptxas.txt`.

Nothing here runs at import: the CPU tests import every module of the
port on machines without nvcc or a GPU.
"""

import collections
import ctypes
import fcntl
import functools
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
OBJ = os.path.join(BUILD, "obj")
GENCODE = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = GENCODE + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Kernel launches per kernel name, bumped by each custom op's CUDA kernel
# (library.py) where it launches its kernel (never on the plain CPU path,
# never while torch.export traces); beside them the same launches by the C
# entry they called, which tells a kernel's bodies apart (kernels 2-3 in bf16:
# `pfnl_pfrb_a_bf16_wgmma` or the mma.sync `pfnl_pfrb_a_bf16`).
launches = collections.Counter()
entries = collections.Counter()

_lib = None


def reset_launches():
    launches.clear()
    entries.clear()


def tool(name: str) -> str:
    """Path of the CUDA toolkit's program `name` (nvcc, cuobjdump, cu++filt)."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(home, "bin", name)
    if os.path.exists(path):
        return path
    path = shutil.which(name)
    if path is None:
        raise RuntimeError(f"{name} not found: set CUDA_HOME or put {name} on PATH")
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
        os.makedirs(OBJ, exist_ok=True)
        nvcc = tool("nvcc")
        t0 = time.perf_counter()
        objs, procs = [], []
        for src in sources():
            obj = os.path.join(OBJ, os.path.basename(src)[:-3] + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
            objs.append(obj)
            procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                stderr=subprocess.STDOUT, text=True)))
        report, failed = [], []
        for cmd, proc in procs:
            out = proc.communicate()[0]
            report.append(out)
            if proc.returncode != 0:
                failed.append(f"nvcc failed with code {proc.returncode}:\n{' '.join(cmd)}\n{out}")
        if failed:
            raise RuntimeError("\n".join(failed))
        tmp = f"{LIB}.{os.getpid()}.tmp"
        cmd = [nvcc, *GENCODE, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed with code {proc.returncode}:\n"
                               f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}")
        seconds = time.perf_counter() - t0
        with open(PTXAS_LOG, "w") as f:
            f.write("".join(report))
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


def constant(name: str) -> int:
    """The int returned by the library's no-argument C entry `name`."""
    fn = getattr(_library(), name)
    fn.argtypes, fn.restype = [], ctypes.c_int
    return fn()


def query(name: str, *ints: int) -> int:
    """The long long returned by the library's C entry `name` of int
    arguments (a size the entry's caller allocates)."""
    fn = getattr(_library(), name)
    if fn.restype is not ctypes.c_longlong:
        fn.argtypes, fn.restype = [ctypes.c_int] * len(ints), ctypes.c_longlong
    return fn(*ints)


@functools.cache
def splat_max_disp() -> int:
    """The largest flow bound kernels 7 and 8 take on the card: MAX_R of
    csrc/splat_tile.cuh, which their tiles' halo is sized for."""
    return constant("pfnl_splat_max_r")


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


def check_no_grad(name: str, *tensors):
    """A kernel writes its outputs through raw pointers, outside autograd's
    graph.  Raise rather than cut the graph without saying so when grad
    is enabled and any input or parameter requires it; gradients reach the
    kernels only through their autograd Functions (ops/pfrb_chain.py, the
    tail's `MergeTail`, and the splats' `BoundedSplat` / `SpmcSplat`, which
    ops/warp.py routes to), whose forwards run with grad disabled."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: a CUDA kernel records no autograd graph, and an input requires grad; "
            "call it under torch.no_grad()/torch.inference_mode(), or train through "
            "pfrb_chain / merge_tail / ops.warp.forward_warp_local / forward_warp_spmc")


def weight_f32(w: torch.Tensor, dtype: torch.dtype, device) -> torch.Tensor:
    """A parameter rounded to the activation dtype (as the plain version
    casts it at use), then held as contiguous float32 for the kernel.
    Callers have passed check_no_grad, so no graph is lost here."""
    return w.detach().to(device=device, dtype=dtype).float().contiguous()


def kernel_weight(w: torch.Tensor, dtype: torch.dtype, device) -> torch.Tensor:
    """A conv or product weight as the entry for `dtype` reads it: bf16 for
    the tensor-core entries, float32 otherwise; rounded to dtype either way."""
    if dtype == torch.bfloat16:
        return w.detach().to(device=device, dtype=dtype).contiguous()
    return weight_f32(w, dtype, device)
