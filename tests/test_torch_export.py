"""AOT export of the port (pfnl_tpu_torch/infer/export.py) against the JAX
package's (tests/test_export.py), and the kernels as `torch.library` custom
ops (pfnl_tpu_torch/ops/cuda/library.py), on the CPU.

On the CPU a serving program runs the kernels' plain versions, so these
artifacts hold no `pfnl` op; the artifacts that hold them are exported on
the card (tests/test_torch_gpu.py, chip_smoke.py phase 13).  Here: the
round trip and its meta, the refusals, DUF-16L with its BatchNorm
statistics, the CLI, a Y family's RGB program, each op's fake
implementation, and the constants cache under tracing.  Tolerance 1e-5
against JAX (float32, the same arithmetic in other summation orders; JAX's
own round trip holds 1e-6); the port's artifact against its eager forward
bitwise."""

import io
import os
import subprocess
import sys
import zipfile

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensor, FakeTensorMode

torch.set_num_threads(2)

from pfnl_tpu.infer.export import export_model as j_export_model, load_exported as j_load
from pfnl_tpu.infer.predictor import make_serving_fn
from pfnl_tpu.models.duf import DUF as JDUF
from pfnl_tpu.models.pfnl import PFNL as JPFNL
from pfnl_tpu.models.vespcn import VESPCN as JVESPCN

from pfnl_tpu_torch.__main__ import main
from pfnl_tpu_torch.config import preset
from pfnl_tpu_torch.infer.export import export_model, load_exported, read_meta, serving_program
from pfnl_tpu_torch.infer.predictor import serve
from pfnl_tpu_torch.models import DUF, FRVSR, VESPCN
from pfnl_tpu_torch.models.pfnl import PFNL
from pfnl_tpu_torch.ops import constants, warp
from pfnl_tpu_torch.ops.cuda import KERNELS, _build, library
from pfnl_tpu_torch.ops.duf_ref import BlockParams, conv3x3x3_ref, dense_block_ref
from pfnl_tpu_torch.ops.nonlocal_attn import nonlocal_attention_chunked
from pfnl_tpu_torch.ops.pfrb_ref import (fold_d2s_conv, pfnl_tail_ref, pfrb_a_ref, pfrb_b_ref,
                                         pfrb_bwd_a_ref, pfrb_bwd_b_ref)
from pfnl_tpu_torch.train.trainer import Trainer
from pfnl_tpu_torch.utils.weights import from_flax

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(model, params, stats=None):
    model.load_state_dict(from_flax(_np(params), None if stats is None else _np(stats)))
    return model.eval()


def test_export_roundtrip_pfnl(tmp_path):
    """PFNL, 3 frames, 2 blocks, 16x16, batch 2: the artifact (from a file)
    against JAX's artifact of the same weights, and against the eager
    forward; its meta."""
    rng = np.random.default_rng(0)
    x = rng.random((2, 3, 16, 16, 3), np.float32)
    jm = JPFNL(num_frames=3, num_blocks=2)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    want = np.asarray(j_load(j_export_model(jm, variables, batch=2, frames=3, hw=(16, 16)))(
        jnp.asarray(x)))

    model = _port(PFNL(num_frames=3, num_blocks=2), variables["params"])
    blob = export_model(model, 2, 3, (16, 16))
    meta = read_meta(blob)
    assert meta == {"in_shape": [2, 3, 16, 16, 3], "in_dtype": "float32", "device": "cpu",
                    "model": "PFNL"}
    path = tmp_path / "m.pt2"
    path.write_bytes(blob)
    fn = load_exported(str(path))
    assert fn.meta == meta
    out = fn(torch.from_numpy(x))
    with torch.no_grad():
        assert torch.equal(out, model(torch.from_numpy(x)))
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)


def test_export_rejects_wrong_shape_and_dtype():
    model = PFNL(num_frames=3, num_blocks=1)
    fn = load_exported(export_model(model, 1, 3, (16, 16)))
    with pytest.raises(ValueError, match="takes"):
        fn(torch.zeros(2, 3, 16, 16, 3))
    with pytest.raises(ValueError, match="takes"):
        fn(torch.zeros(1, 3, 16, 16, 3, dtype=torch.float64))
    assert fn(torch.zeros(1, 3, 16, 16, 3)).shape == (1, 1, 64, 64, 3)


@pytest.mark.parametrize("name", ["pfnl", "vespcn"])
def test_load_exported_drops_the_metadata_checks(name):
    """The saved program keeps export's aten._assert_tensor_metadata nodes;
    the loaded callable runs without them, every other node kept, and gives
    the eager serving program's output bitwise."""
    model = (PFNL(num_frames=3, num_blocks=1) if name == "pfnl" else VESPCN(num_frames=3)).eval()
    blob = export_model(model, 1, 3, (8, 8), model_name=name)
    fn = load_exported(blob)
    check = torch.ops.aten._assert_tensor_metadata.default

    def targets(graph):
        return [n.target for n in graph.nodes if n.op == "call_function"]

    saved = targets(torch.export.load(io.BytesIO(blob)).module().graph)
    assert check in saved
    assert targets(fn._module.graph) == [t for t in saved if t is not check]
    x = torch.rand(1, 3, 8, 8, 3, generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        assert torch.equal(fn(x), serving_program(model, name)(x))


def test_export_duf16_with_batch_stats():
    """DUF-16L in eval mode with seeded BatchNorm statistics (the init's
    variance of 0 gives activations of 1e17), the raw program, against
    JAX's artifact of the same variables."""
    rng = np.random.default_rng(1)
    x = rng.random((1, 7, 12, 12, 3), np.float32)
    jm = JDUF(num_frames=7, layers=16)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), is_train=False)

    def seeded(path, leaf):
        name = getattr(path[-1], "key", "")
        if name in ("moving_mean", "biased_mean"):
            return (rng.standard_normal(leaf.shape) * 0.1).astype(np.float32)
        if name in ("moving_variance", "biased_var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        return np.asarray(leaf)

    stats = jax.tree_util.tree_map_with_path(seeded, variables["batch_stats"])
    variables = {"params": variables["params"], "batch_stats": stats}
    want = np.asarray(j_load(j_export_model(jm, variables, batch=1, frames=7, hw=(12, 12),
                                            extra_kwargs={"is_train": False}))(jnp.asarray(x)))
    model = _port(DUF(layers=16), variables["params"], stats)
    out = load_exported(export_model(model, 1, 7, (12, 12)))(torch.from_numpy(x))
    assert out.shape == want.shape == (1, 1, 48, 48, 3)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)
    assert not model.training  # export_model gives the model back in its mode


def test_export_cli(tmp_path, monkeypatch):
    """`export pfnl` on a port checkpoint at 8x8 -> [1,1,32,32,3], the
    restored model's forward; the line run.py prints."""
    cfg = preset("pfnl", in_size=8, batch_size=1, reload=False, save_dir=str(tmp_path / "ck"))
    tr = Trainer(cfg, device="cpu")
    tr.save()
    out = str(tmp_path / "pfnl.pt2")
    monkeypatch.chdir(tmp_path)
    main(["export", "pfnl", "--save-dir", str(tmp_path / "ck"), "--hw", "8x8", "--batch", "1",
          "--out", out, "--device", "cpu"])
    fn = load_exported(out)
    x = torch.from_numpy(np.random.default_rng(2).random((1, 7, 8, 8, 3), np.float32))
    sr = fn(x)
    assert sr.shape == (1, 1, 32, 32, 3) and torch.isfinite(sr).all()
    with torch.no_grad():
        assert torch.equal(sr, tr.model.eval()(x))
    assert fn.meta["model"] == "pfnl"


def test_export_cli_prints_runs_line(tmp_path, capsys):
    main(["export", "pfnl", "--save-dir", str(tmp_path / "none"), "--hw", "8x8", "--batch", "1",
          "--out", str(tmp_path / "p.pt2"), "--device", "cpu"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"exported pfnl [1,7,8,8,3] -> {tmp_path / 'p.pt2'} (")
    assert line.endswith(" MB)")


def test_export_y_family_emits_rgb():
    """VESPCN's artifact is its whole serving program: RGB [2,48,48,3] (SR Y
    + bicubic CbCr), against JAX's make_serving_fn on the same weights."""
    rng = np.random.default_rng(3)
    x = rng.random((2, 3, 12, 12, 3), np.float32)
    jm = JVESPCN(num_frames=3)
    variables = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))
    per_chip, _ = make_serving_fn("vespcn", jm, 3)
    want = np.asarray(per_chip(variables, jnp.asarray(x)))
    model = _port(VESPCN(num_frames=3), variables["params"])
    fn = load_exported(export_model(model, 2, 3, (12, 12), model_name="vespcn"))
    out = fn(torch.from_numpy(x))
    assert out.shape == (2, 48, 48, 3)
    np.testing.assert_allclose(out.numpy(), want, atol=1e-5)
    with torch.no_grad():
        assert torch.equal(out, serve(model, torch.from_numpy(x)))


def test_export_frvsr_holds_its_windowed_forward():
    model = FRVSR(num_frames=3, generator=torch.Generator().manual_seed(5)).eval()
    x = torch.rand(1, 3, 8, 8, 3, generator=torch.Generator().manual_seed(6))
    out = load_exported(export_model(model, 1, 3, (8, 8), model_name="frvsr"))(x)
    with torch.no_grad():
        assert torch.equal(out, model(x)["sr"])
    assert out.shape == (1, 3, 32, 32, 3)


def test_read_meta_rejects_garbage():
    with pytest.raises(ValueError):
        read_meta(b"GARBAGE!" + b"\x00" * 32)
    buf = io.BytesIO()
    with zipfile.ZipFile(buf, "w") as z:  # a zip, but no artifact
        z.writestr("archive/extra/other.json", "{}")
    with pytest.raises(ValueError):
        read_meta(buf.getvalue())


def test_export_first_then_serve_eagerly(monkeypatch):
    """The constants cache (ops/constants.py) first filled while torch.export
    traces on fake tensors: it keeps real tensors, so an eager forward after
    the export works and matches the exported program."""
    monkeypatch.setattr(constants, "_CACHE", {})
    model = PFNL(num_frames=3, num_blocks=1).eval()
    x = torch.rand(1, 3, 8, 8, 3, generator=torch.Generator().manual_seed(7))
    with torch.no_grad():
        ep = torch.export.export(model, (x,), strict=False)
    assert constants._CACHE  # filled during the trace (the bicubic matrices, the fold index)
    assert not any(isinstance(t, FakeTensor) for t in constants._CACHE.values())
    with torch.no_grad():
        assert torch.equal(model(x), ep.module()(x))


def test_export_model_lifts_the_constants_made_before_the_trace(monkeypatch):
    """export_model's eager call fills the cache first, so the program uses
    each constant as lifted: no lift_fresh_copy, no conversion at each call
    (a constant first made while tracing comes in as a host array converted
    at every call, which on the card is a pageable upload)."""
    monkeypatch.setattr(constants, "_CACHE", {})
    ep = torch.export.load(io.BytesIO(export_model(PFNL(num_frames=3, num_blocks=1), 1, 3,
                                                   (8, 8))))
    assert ep.constants
    assert not [n for n in ep.graph.nodes if "lift_fresh" in str(n.target)]


def test_importing_the_port_registers_every_op_and_builds_nothing():
    """A fresh process: `import pfnl_tpu_torch` registers torch.ops.pfnl.<each
    kernel>, loads no library and runs no nvcc."""
    code = ("import torch, pfnl_tpu_torch\n"
            "from pfnl_tpu_torch.ops.cuda import KERNELS, _build\n"
            "assert all(hasattr(torch.ops.pfnl, k) for k in KERNELS), KERNELS\n"
            "assert _build._lib is None\n"
            "import sys; assert not [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'flax', 'pfnl_tpu')]\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr[-2000:]
    for k in KERNELS:  # a CUDA kernel and a fake one, no CPU kernel (the wrapper has the plain)
        op = getattr(torch.ops.pfnl, k).default
        assert torch._C._dispatch_has_kernel_for_dispatch_key(op.name(), "CUDA"), k
        assert not torch._C._dispatch_has_kernel_for_dispatch_key(op.name(), "CPU"), k


def _duf_params(g, f, grow, mode, dt):
    t = lambda *s: torch.randn(*s, generator=g).to(dt)  # noqa: E731
    return BlockParams(t(f), t(f), t(f, f), t(f), t(f), t(3, 3, 3, f, grow), t(grow), mode)


def _cases(dt):
    """op -> (the op's arguments, as the wrapper hands them over; the plain
    version's output) at a small shape."""
    g = torch.Generator().manual_seed(8)
    t = lambda *s: torch.randn(*s, generator=g).to(dt)  # noqa: E731
    feat, w3, b = t(1, 3, 4, 4, 64), t(3, 3, 64, 64), t(64)
    wfuse = t(3, 64, 64)
    i1, base = pfrb_a_ref(feat, w3, b, wfuse, b)
    wm1, bm1, km2, bm2 = t(3, 3, 3 * 64, 48), t(48), t(3, 3, 12, 12), t(12)
    im, uv = t(2, 8, 8, 3), t(2, 8, 8, 2)
    im1 = t(2, 8, 8, 1)
    p = _duf_params(g, 16, 16, "thw", dt)
    buf = t(1, 3, 4, 4, 32)
    x, wk = t(1, 5, 4, 4, 16), t(3, 3, 3, 16, 16)
    theta, phi, gv = t(2, 10, 8), t(2, 12, 8), t(2, 12, 5)
    return {
        "nonlocal_flash": ((theta, phi, gv), nonlocal_attention_chunked(theta, phi, gv)),
        "pfrb_a": ((feat, w3, b, wfuse, b), (i1, base)),
        "pfrb_b": ((feat, i1, base, w3, w3, b), pfrb_b_ref(feat, i1, base, w3, w3, b)),
        "pfnl_tail": ((feat, wm1, bm1, fold_d2s_conv(km2), bm2.repeat(4)),
                      pfnl_tail_ref(feat, wm1, bm1, km2, bm2)),
        "pfrb_bwd_b": ((feat, i1, base, w3, w3), pfrb_bwd_b_ref(feat, i1, base, w3, w3)),
        "pfrb_bwd_a": ((feat, feat, feat, w3), pfrb_bwd_a_ref(feat, feat, feat, w3)),
        "bounded_splat": ((im, uv, 2), warp.forward_warp_local_ref(im, uv, 2)),
        "spmc_splat": ((im1, uv, 4, 2), warp.forward_warp_local_spmc(im1, uv, 4, 2)),
        "duf_block": ((buf, torch.empty(3 * 16 * 16, dtype=dt), *p[:7], 0, 3, True),
                      dense_block_ref(buf.clone(), p, 0, 3)),
        "duf_dense": ((x, wk, False), conv3x3x3_ref(x, wk, False)),
    }


def _flat(out):
    """The op's outputs as the wrapper returns them: kernels 5 and 6 hand
    back each weight gradient with its bias gradient as one float32 vector."""
    return [o for o in (out if isinstance(out, (tuple, list)) else (out,))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", KERNELS)
def test_fake_gives_the_plain_versions_shapes_and_dtypes(name, dtype):
    """Under FakeTensorMode each op's fake implementation gives outputs of
    the plain version's shapes and dtypes (the weight gradients of kernels
    5 and 6 as one float32 vector of dW and db), launches nothing and counts
    nothing."""
    args, plain = _cases(dtype)[name]
    before = dict(_build.launches)
    with FakeTensorMode() as mode:
        fargs = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a for a in args]
        got = getattr(torch.ops.pfnl, name)(*fargs)
    assert dict(_build.launches) == before and _build._lib is None
    if name == "duf_block":  # in place: the buffer, as the plain version returns it
        assert got is None and fargs[0].shape == plain.shape and fargs[0].dtype == plain.dtype
        return
    got, plain = _flat(got), _flat(plain)
    assert all(isinstance(o, FakeTensor) for o in got)
    if name.startswith("pfrb_bwd"):
        n_data = 2 if name == "pfrb_bwd_b" else 1
        for o, w in zip(got[:n_data], plain[:n_data]):
            assert (o.shape, o.dtype) == (w.shape, w.dtype)
        # each vector holds a [3,3,64,64] weight gradient, then 64 bias entries (kernel 5's
        # second vector leaves them unwritten: W2b has no bias)
        entries = plain[n_data].numel() + plain[-1].numel()
        assert entries == library.WGRAD_ENTRIES
        assert len(got) - n_data == len(plain) - n_data - 1
        assert all(o.shape == (entries,) and o.dtype == torch.float32 for o in got[n_data:])
        return
    assert [(o.shape, o.dtype) for o in got] == [(w.shape, w.dtype) for w in plain]


def test_a_cpu_artifact_holds_no_pfnl_node():
    """On the CPU the wrappers run the plain versions, so an exported CPU
    program holds no pfnl op (the card's artifacts: tests/test_torch_gpu.py)."""
    ep = torch.export.load(io.BytesIO(export_model(PFNL(num_frames=3, num_blocks=1), 1, 3,
                                                   (8, 8)))).graph
    assert not [n for n in ep.nodes if "pfnl" in str(n.target)]
