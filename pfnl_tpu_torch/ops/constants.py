"""Host-made constants (resampling matrices, colour matrices, the blur
kernel) held on each device after their first use.  Uploading a numpy array
at every call is a copy from pageable memory, which waits for all the work
queued on the stream: inside a forward it would make the host wait for the
device, and the Predictor's next batch could not be queued while the
current one computes (infer/predictor.py)."""

import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily

_CACHE = {}


def on_device(key, make, device, dtype) -> torch.Tensor:
    """make() -> numpy array, uploaded as `dtype` to `device` at the first
    call for (key, device, dtype) and reused after.  Made outside inference
    mode, so a forward under autograd may save it for its backward, and
    outside any fake-tensor mode, so the cache holds a real tensor even when
    its first call comes while `torch.export` traces (which then lifts it
    into the program as a constant) and later eager calls find it intact."""
    k = (key, torch.device(device), dtype)
    t = _CACHE.get(k)
    if t is None:
        with torch.inference_mode(False), unset_fake_temporarily():
            t = torch.as_tensor(make(), device=device).to(dtype)
        _CACHE[k] = t
    return t
