"""AOT export of a serving program — counterpart of pfnl_tpu/infer/export.py.

`export_model` traces a model's complete serving program at a fixed
geometry with `torch.export` (non-strict, eval mode, grad off) and returns
the `torch.export.save` bytes of the program, its weights baked in, with the
artifact's meta (input shape, dtype and device, model name) among its extra
files.  With `model_name` the program is the family's whole serving
program, as the JAX package's `make_serving_fn` has it: a model whose
`y_channel` is set, as the Predictor's `serve` reads it (VESPCN, MCResNet,
LTDVSR, DRVSR), emits final RGB [B,H,W,3] (SR Y + bicubic
CbCr -> ycbcr2rgb, DRVSR with `last_only`), PFNL and DUF their RGB
[B,1,H,W,3], FRVSR its windowed forward's "sr" [B,T,H,W,3] (the streaming
path's state feedback is a Python loop and stays with the Predictor).
Without it, the model's raw "sr".

On a CUDA device every kernel launch of the program is a `torch.ops.pfnl`
custom op (ops/cuda/library.py), so the artifact holds the port's kernels,
as the JAX artifact holds its Pallas kernels as `tpu_custom_call`s; the
weight casts in front of them are graph nodes.  Tracing runs under
`torch.no_grad()`: the kernels refuse inputs that require grad, and DUF
takes kernel 9 only with grad off.  One eager call of the program comes
first: it fills the host-made constants' cache (ops/constants.py) with
tensors on the device, which the export then lifts as they are.  A
constant first made while tracing would be recorded as a host array and
its upload, a pageable copy at every call that makes the host wait for the
device (PR 6's trap, inside the artifact).

`load_exported` restores a callable from the artifact: it needs the `pfnl`
ops registered (it imports ops/cuda/library.py, no model code) and refuses
an input whose shape, dtype or device is not the artifact's, as the JAX
artifact's platform check refuses another platform.  It drops export's
`aten._assert_tensor_metadata` nodes from the program it runs: each checks
the dtype and device of a cast's input, which the fixed trace and the input
check settle, and each is a host operator a call (216 of them for PFNL).

    python -m pfnl_tpu_torch export pfnl --save-dir ckpt/pfnl --hw 180x320 --batch 4 \
        --compute-dtype bfloat16 --out pfnl_720p.pt2
    fn = load_exported("pfnl_720p.pt2"); sr = fn(lr_batch)
"""

import copy
import io
import json
import zipfile

import torch

META_FILE = "pfnl_meta.json"  # the meta's name among the artifact's extra files


def serving_program(model, model_name=None, extra_kwargs=None):
    """fn(x) -> the output an artifact of `model` returns (see above)."""
    from pfnl_tpu_torch.infer.predictor import serve_rgb

    if model_name is not None and model.y_channel:
        return lambda x: serve_rgb(model, x)
    kw = {} if model_name is not None else dict(extra_kwargs or {})

    def fn(x):
        out = model(x, **kw)
        return out["sr"] if isinstance(out, dict) else out

    return fn


class _Program(torch.nn.Module):
    def __init__(self, model, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def export_model(model, batch: int, frames: int, hw, *, dtype=torch.float32, device=None,
                 model_name=None, extra_kwargs=None) -> bytes:
    """The artifact (bytes) of `model`'s serving program for input
    [batch, frames, h, w, 3] of `dtype` on `device` (the model's device by
    default; a model elsewhere is copied there).  model_name: the family
    ("pfnl", "vespcn", ...), for its whole serving program; None exports
    model(x, **extra_kwargs)["sr"] raw."""
    h, w = hw
    param = next(model.parameters())
    device = torch.device(device) if device is not None else param.device
    if param.device != device:
        model = copy.deepcopy(model).to(device)
    was_training = model.training
    model.eval()
    try:
        program = _Program(model, serving_program(model, model_name, extra_kwargs))
        x = torch.zeros((batch, frames, h, w, 3), dtype=dtype, device=device)
        with torch.no_grad():
            program(x)  # the constants, made on the device before the trace
            ep = torch.export.export(program, (x,), strict=False)
    finally:
        model.train(was_training)
    ep.example_inputs = None  # the meta keeps the input's shape; the zeros need no bytes
    meta = {"in_shape": [batch, frames, h, w, 3], "in_dtype": str(dtype).replace("torch.", ""),
            "device": str(device), "model": model_name or type(model).__name__}
    buf = io.BytesIO()
    torch.export.save(ep, buf, extra_files={META_FILE: json.dumps(meta)})
    return buf.getvalue()


def read_meta(blob: bytes) -> dict:
    """The meta of an artifact; ValueError for anything that is not one."""
    try:
        with zipfile.ZipFile(io.BytesIO(blob)) as z:
            names = [n for n in z.namelist() if n.endswith(f"extra/{META_FILE}")]
            if len(names) == 1:
                return json.loads(z.read(names[0]).decode())
    except (zipfile.BadZipFile, UnicodeDecodeError, json.JSONDecodeError):
        pass
    raise ValueError("not a pfnl_tpu_torch export artifact")


def _without_metadata_checks(module: torch.fx.GraphModule) -> torch.fx.GraphModule:
    """`module` without its `aten._assert_tensor_metadata` nodes."""
    check = torch.ops.aten._assert_tensor_metadata.default
    for node in [n for n in module.graph.nodes if n.op == "call_function" and n.target is check]:
        module.graph.erase_node(node)
    module.recompile()
    return module


class Exported:
    """A loaded artifact: call it on an input of the artifact's shape,
    dtype and device.  `.meta` is the artifact's meta, `.program` the
    ExportedProgram."""

    def __init__(self, program, meta):
        self.program = program
        self.meta = meta
        self._module = _without_metadata_checks(program.module())
        self._shape = tuple(meta["in_shape"])
        self._dtype = getattr(torch, meta["in_dtype"])
        self._device = torch.device(meta["device"])

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape) != self._shape or x.dtype != self._dtype or x.device != self._device:
            raise ValueError(f"the artifact takes {list(self._shape)} {self.meta['in_dtype']} on "
                             f"{self._device}, got {list(x.shape)} {x.dtype} on {x.device}")
        with torch.no_grad():
            return self._module(x)


def load_exported(path_or_bytes) -> Exported:
    """Restore a callable from an artifact (bytes, or a path to one)."""
    from pfnl_tpu_torch.ops.cuda import library  # noqa: F401  (the ops the program calls)

    if isinstance(path_or_bytes, (bytes, bytearray)):
        blob = bytes(path_or_bytes)
    else:
        with open(path_or_bytes, "rb") as f:
            blob = f.read()
    meta = read_meta(blob)
    return Exported(torch.export.load(io.BytesIO(blob)), meta)
