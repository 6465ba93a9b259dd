"""The port's CUDA kernels against their plain PyTorch versions, on a CUDA
GPU.  Marked `gpu`; each test skips when torch.cuda.is_available() is
False.  Imports no jax, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q -p no:cacheprovider

Tolerance: max |kernel - plain| <= TOL * max |plain|, with TF32 off on the
plain side.  float32: both sides sum in float32 in different orders.
bfloat16: the plain side rounds to bf16 after every op, the kernel once
per output, so they differ by a few bf16 ulps (2^-8 relative each).
"""

import pytest
import torch

from pfnl_tpu_torch.infer.profile_serving import seeded_model
from pfnl_tpu_torch.models import DRVSR, DUF, LTDVSR, MCResNet, VESPCN
from pfnl_tpu_torch.models.blocks import NonLocalBlock
from pfnl_tpu_torch.models.duf import bn_cancelled_bias
from pfnl_tpu_torch.models.pfnl import PFNL
from pfnl_tpu_torch.ops.cuda import _build, entries, launches, reset_launches
from pfnl_tpu_torch.ops.cuda.bounded_splat import bounded_splat
from pfnl_tpu_torch.ops.cuda.duf_block import dense_block
from pfnl_tpu_torch.ops.cuda.duf_dense import conv3x3x3, duf_dense
from pfnl_tpu_torch.ops.cuda.nonlocal_flash import nonlocal_flash
from pfnl_tpu_torch.ops.cuda.pfnl_tail import pfnl_tail
from pfnl_tpu_torch.ops.cuda.pfrb import pfrb_a, pfrb_b
from pfnl_tpu_torch.ops.cuda.pfrb_bwd import pfrb_bwd_a, pfrb_bwd_b
from pfnl_tpu_torch.ops.cuda.spmc_splat import spmc_splat
from pfnl_tpu_torch.ops.duf_ref import BlockParams, conv3x3x3_ref, dense_block_ref
from pfnl_tpu_torch.ops.losses import charbonnier
from pfnl_tpu_torch.ops.nonlocal_attn import nonlocal_attention_chunked
from pfnl_tpu_torch.ops.pfrb_ref import (pfnl_tail_ref, pfrb_a_ref, pfrb_b_ref, pfrb_bwd_a_ref,
                                         pfrb_bwd_b_ref)
from pfnl_tpu_torch.ops.warp import (forward_warp_local, forward_warp_local_ref,
                                     forward_warp_local_spmc, forward_warp_spmc)

pytestmark = pytest.mark.gpu

TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.Generator(device="cuda").manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _randn(gen, *shape, scale=1.0):
    return torch.randn(shape, generator=gen, device="cuda") * scale


def _assert_close(got, ref, dtype):
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    torch.cuda.synchronize()
    for a, b in zip(got, ref):
        assert a.shape == b.shape and a.dtype == b.dtype
        err = (a.float() - b.float()).abs().max().item()
        assert err <= TOL[dtype] * b.float().abs().max().item(), err


def _nan_view(x, offset):
    """x's values in a contiguous view that starts `offset` elements into a
    NaN-filled allocation and has NaN after it: a read outside x gives NaN.
    An odd offset leaves the view only 2-byte aligned."""
    buf = torch.full((offset + x.numel() + 64,), float("nan"), dtype=x.dtype, device=x.device)
    view = buf[offset:offset + x.numel()].view(x.shape)
    view.copy_(x)
    return view


def _attention_inputs(gen, dtype, b, n, m, d, dv=None):
    theta = torch.rand((b, n, d), generator=gen, device="cuda").to(dtype)
    phi = torch.rand((b, m, d), generator=gen, device="cuda").to(dtype)
    return theta, phi, _randn(gen, b, m, dv or d).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d,dv", [(30, 30), (84, 84), (96, 96), (30, 96), (96, 30), (16, 16)])
@pytest.mark.parametrize("b,n,m", [(2, 256, 256), (1, 300, 200), (1, 1000, 777), (1, 1, 1),
                                   (1, 127, 127), (1, 128, 128), (1, 129, 129), (1, 1, 1000),
                                   (1, 1000, 1), (1, 129, 127), (4, 1000, 1000)])
def test_nonlocal_flash_kernel(gen, dtype, b, n, m, d, dv):
    """Kernel 1 at D and Dv below, at and on the padded widths (bf16: D to
    96, Dv to 88 or 96), apart and equal, with N and M at the edges of the
    128-query blocks and 128-key tiles and beyond, N != M, four windows of
    different content; two calls bitwise equal."""
    theta, phi, g = _attention_inputs(gen, dtype, b, n, m, d, dv)
    got = nonlocal_flash(theta, phi, g)
    _assert_close(got, nonlocal_attention_chunked(theta, phi, g), dtype)
    assert torch.equal(got, nonlocal_flash(theta, phi, g))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [14400, 129600])
def test_nonlocal_flash_peaked_softmax(gen, dtype, n):
    """PFNL's self-attention at 720p and at 4K: theta = phi in [0, 1),
    [1, n, 84], scores up to about 84 on the diagonal."""
    theta = torch.rand((1, n, 84), generator=gen, device="cuda").to(dtype)
    g = _randn(gen, 1, n, 84).to(dtype)
    got = nonlocal_flash(theta, theta, g)
    assert torch.isfinite(got).all()
    _assert_close(got, nonlocal_attention_chunked(theta, theta, g), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("offset", [8, 1])
def test_nonlocal_flash_reads_only_its_inputs(gen, dtype, offset):
    """theta, phi and g as views into NaN-filled allocations, 16-byte aligned
    (offset 8) or not (offset 1): the output is finite and right."""
    theta, phi, g = _attention_inputs(gen, dtype, 2, 300, 200, 84, 96)
    got = nonlocal_flash(*(_nan_view(x, offset) for x in (theta, phi, g)))
    assert torch.isfinite(got).all()
    _assert_close(got, nonlocal_attention_chunked(theta, phi, g), dtype)


def _pfrb_params(gen, t, c=64):
    return (_randn(gen, 3, 3, c, c, scale=0.06), _randn(gen, c, scale=0.1),
            _randn(gen, t, c, c, scale=0.1), _randn(gen, c, scale=0.1),
            _randn(gen, 3, 3, c, c, scale=0.04), _randn(gen, 3, 3, c, c, scale=0.04),
            _randn(gen, c, scale=0.1))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 7, 9, 13), (2, 3, 20, 37), (1, 7, 45, 83), (16, 7, 32, 32),
                                   (4, 7, 180, 320), (1, 7, 540, 960)])
def test_pfrb_kernels(gen, dtype, shape):
    """Kernels 2 and 3 at T = 7 and 3, with H and W not multiples of the
    bf16 kernels' 2 x 64 tile (nor of the mma.sync one's 8 x 32, nor of the
    float32 ones' 8 x 16), at the training shape (batch 16, LR 32x32) and at
    the serving shapes of 720p and 4K; a second launch is bitwise the
    same."""
    n, t, h, w = shape
    feat = _randn(gen, n, t, h, w, 64, scale=0.5).to(dtype)
    w1, b1, wfuse, bfuse, w2f, w2b, b2 = _pfrb_params(gen, t)
    i1, base = pfrb_a_ref(feat, w1, b1, wfuse, bfuse)
    got_a = pfrb_a(feat, w1, b1, wfuse, bfuse)
    _assert_close(got_a, (i1, base), dtype)
    got_b = pfrb_b(feat, i1, base, w2f, w2b, b2)
    _assert_close(got_b, pfrb_b_ref(feat, i1, base, w2f, w2b, b2), dtype)
    again_a, again_b = pfrb_a(feat, w1, b1, wfuse, bfuse), pfrb_b(feat, i1, base, w2f, w2b, b2)
    for a, b in zip(got_a + (got_b,), again_a + (again_b,)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("offset", [8, 1])
def test_pfrb_kernels_read_only_their_inputs(gen, dtype, offset):
    """feat, i1 and base as views into NaN-filled allocations, 16-byte
    aligned (offset 8) or not (offset 1): halo pixels outside the image are
    never read, and the outputs are finite and right."""
    n, t, h, w = 1, 7, 21, 45
    feat = _randn(gen, n, t, h, w, 64, scale=0.5).to(dtype)
    w1, b1, wfuse, bfuse, w2f, w2b, b2 = _pfrb_params(gen, t)
    i1, base = pfrb_a_ref(feat, w1, b1, wfuse, bfuse)
    got_a = pfrb_a(_nan_view(feat, offset), w1, b1, wfuse, bfuse)
    got_b = pfrb_b(*(_nan_view(x, offset) for x in (feat, i1, base)), w2f, w2b, b2)
    assert all(torch.isfinite(x).all() for x in got_a + (got_b,))
    _assert_close(got_a, (i1, base), dtype)
    _assert_close(got_b, pfrb_b_ref(feat, i1, base, w2f, w2b, b2), dtype)


@pytest.mark.parametrize("shape,offset,body", [((4, 7, 180, 320), None, "bf16_wgmma"),
                                                ((1, 7, 540, 960), None, "bf16_wgmma"),
                                                ((16, 7, 32, 32), None, "bf16_wgmma"),
                                                ((1, 7, 21, 45), 8, "bf16_wgmma"),
                                                ((1, 7, 21, 45), 1, "bf16")])
def test_pfrb_bf16_entries_by_input(gen, shape, offset, body):
    """Which body each bf16 launch took, by the per-entry count: fresh inputs
    at the serving shapes and the training crop, and views 16-byte aligned,
    take the wgmma body; views one element in (2-byte aligned) keep the
    mma.sync body.  `launches` still counts one of each op."""
    n, t, h, w = shape
    feat = _randn(gen, n, t, h, w, 64, scale=0.5).to(torch.bfloat16)
    w1, b1, wfuse, bfuse, w2f, w2b, b2 = _pfrb_params(gen, t)
    i1, base = pfrb_a_ref(feat, w1, b1, wfuse, bfuse)
    view = (lambda x: x) if offset is None else (lambda x: _nan_view(x, offset))
    reset_launches()
    got_a = pfrb_a(view(feat), w1, b1, wfuse, bfuse)
    got_b = pfrb_b(*(view(x) for x in (feat, i1, base)), w2f, w2b, b2)
    assert dict(entries) == {f"pfnl_pfrb_a_{body}": 1, f"pfnl_pfrb_b_{body}": 1}
    assert dict(launches) == {"pfrb_a": 1, "pfrb_b": 1}
    _assert_close(got_a, (i1, base), torch.bfloat16)
    _assert_close(got_b, pfrb_b_ref(feat, i1, base, w2f, w2b, b2), torch.bfloat16)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 7, 9, 13), (2, 3, 20, 37)])
def test_pfnl_tail_kernel(gen, dtype, shape):
    n, t, h, w = shape
    feat = _randn(gen, n, t, h, w, 64, scale=0.5).to(dtype)
    args = (feat, _randn(gen, 3, 3, t * 64, 48, scale=0.02), _randn(gen, 48, scale=0.1),
            _randn(gen, 3, 3, 12, 12, scale=0.1), _randn(gen, 12, scale=0.1))
    _assert_close(pfnl_tail(*args), pfnl_tail_ref(*args), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("offset", [8, 1])
def test_pfnl_tail_reads_only_its_input(gen, dtype, offset):
    """feat as a view into a NaN-filled allocation, 16-byte aligned (offset
    8) or not (offset 1, the element-wise staging of the bf16 kernel): halo
    pixels outside the image are never read, and the output is finite and
    right."""
    n, t, h, w = 1, 7, 21, 45
    feat = _randn(gen, n, t, h, w, 64, scale=0.5).to(dtype)
    args = (_randn(gen, 3, 3, t * 64, 48, scale=0.02), _randn(gen, 48, scale=0.1),
            _randn(gen, 3, 3, 12, 12, scale=0.1), _randn(gen, 12, scale=0.1))
    got = pfnl_tail(_nan_view(feat, offset), *args)
    assert torch.isfinite(got).all()
    _assert_close(got, pfnl_tail_ref(feat, *args), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 7, 9, 13), (2, 3, 20, 37), (16, 7, 32, 32)])
def test_pfrb_bwd_kernels(gen, dtype, shape):
    """Kernels 5 and 6 at ragged tiles and at the training shape (batch 16,
    LR 32x32); their weight gradients are bitwise the same in a second
    run."""
    n, t, h, w = shape
    feat = _randn(gen, n, t, h, w, 64, scale=0.5).to(dtype)
    w1, b1, wfuse, bfuse, w2f, w2b, _ = _pfrb_params(gen, t)
    i1, base = pfrb_a_ref(feat, w1, b1, wfuse, bfuse)
    dz = _randn(gen, n, t, h, w, 64, scale=0.5).to(dtype)
    g = _randn(gen, n, t, h, w, 64, scale=0.5).to(dtype)
    got_b = pfrb_bwd_b(dz, i1, base, w2f, w2b)
    _assert_close(got_b, pfrb_bwd_b_ref(dz, i1, base, w2f, w2b), dtype)
    got_a = pfrb_bwd_a(dz, feat, g, w1)
    _assert_close(got_a, pfrb_bwd_a_ref(dz, feat, g, w1), dtype)
    again_b, again_a = pfrb_bwd_b(dz, i1, base, w2f, w2b), pfrb_bwd_a(dz, feat, g, w1)
    for a, b in zip(got_b[2:] + got_a[1:], again_b[2:] + again_a[1:]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("offset", [8, 1])
def test_pfrb_bwd_kernels_read_only_their_inputs(gen, dtype, offset):
    """Kernels 5 and 6 with every activation and cotangent a view into a
    NaN-filled allocation, 16-byte aligned (offset 8) or not (offset 1, the
    element-wise staging): halo pixels outside the image are never read,
    and the outputs are finite and right."""
    n, t, h, w = 1, 7, 21, 45
    feat = _randn(gen, n, t, h, w, 64, scale=0.5).to(dtype)
    w1, b1, wfuse, bfuse, w2f, w2b, _ = _pfrb_params(gen, t)
    i1, base = pfrb_a_ref(feat, w1, b1, wfuse, bfuse)
    dz = _randn(gen, n, t, h, w, 64, scale=0.5).to(dtype)
    g = _randn(gen, n, t, h, w, 64, scale=0.5).to(dtype)
    got_b = pfrb_bwd_b(*(_nan_view(x, offset) for x in (dz, i1, base)), w2f, w2b)
    got_a = pfrb_bwd_a(*(_nan_view(x, offset) for x in (dz, feat, g)), w1)
    assert all(torch.isfinite(x).all() for x in got_b + got_a)
    _assert_close(got_b, pfrb_bwd_b_ref(dz, i1, base, w2f, w2b), dtype)
    _assert_close(got_a, pfrb_bwd_a_ref(dz, feat, g, w1), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pfnl_kernel_path_matches_plain_path(gen, dtype):
    """The whole forward, and the launches of one forward batch: 65x66
    non-local positions, above the dense limit, so kernel 1 runs."""
    model = PFNL(num_blocks=2, dtype=dtype, generator=torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    x = torch.rand((2, 7, 130, 132, 3), generator=gen, device="cuda")
    want = {"nonlocal_flash": 1, "pfrb_a": 2, "pfrb_b": 2, "pfnl_tail": 1}
    reset_launches()
    with torch.inference_mode():
        got = model(x)
        assert dict(launches) == want
        ref = model(x, plain=True)
    assert dict(launches) == want
    assert got.shape == (2, 1, 520, 528, 3) and torch.isfinite(got).all()
    err = ((got - ref).norm() / ref.norm()).item()
    assert err <= TOL[dtype], err


@pytest.mark.parametrize("family,frames", [("pfnl", 3), ("pfnl", 13), ("frvsr", 13)])
def test_pipelined_predictor_on_the_card_writes_what_the_cpu_writes(gen, family, frames):
    """The Predictor's CUDA path (pinned staging slots used in turn, uint8
    on the card, one unit pending) against its CPU path on the same float32
    weights: the same frame names and len(all_time), every byte within 1
    LSB (kernel vs plain sums).  PFNL, the window path: 3 frames, one
    batch; 13, four batches, the last ragged, so each slot is reused.
    FRVSR, the recurrent path: 13 frames in chunks of 4, frame 0 then three
    chunks."""
    from pfnl_tpu_torch.infer.predictor import MemoryFrames, Predictor

    clip = torch.randint(0, 256, (frames, 40, 52, 3), generator=torch.Generator().manual_seed(1),
                         dtype=torch.uint8).numpy()
    if family == "pfnl":
        model = PFNL(num_blocks=2, generator=torch.Generator().manual_seed(0)).eval()
    else:
        model = seeded_model("frvsr", torch.float32, 0, "cpu", num_frames=3, mf=16, num_blocks=2)
    got = {}
    for dev in ("cpu", "cuda"):
        mem = MemoryFrames({f"c/truth/{i:04d}.png": clip[i] for i in range(frames)})
        pred = Predictor(model.to(dev), source=mem, sink=mem)
        if family == "pfnl":
            times = pred.test_video_truth("c", name="sr")
        else:
            times = pred._run_recurrent(clip.astype("float32") / 255, "c/sr", 4)
        got[dev] = len(times), {p: mem.read(p) for p in mem.list("c/sr")}
    (n_cpu, cpu), (n_cuda, cuda) = got["cpu"], got["cuda"]
    assert n_cuda == n_cpu == -(-frames // 4) and list(cuda) == list(cpu)
    assert len(cuda) == frames
    hw = (40, 52) if family == "pfnl" else (160, 208)
    for p in cpu:
        assert cuda[p].shape == hw + (3,) and cuda[p].dtype == cpu[p].dtype
        assert abs(cuda[p].astype(int) - cpu[p].astype(int)).max() <= 1, p


def test_pfnl_gradients_kernel_path_match_plain_path(gen):
    """One float32 training step's loss and gradients through kernels 2-6
    against pure autograd on the plain path: relative L2 error per
    parameter within 1e-3 (summation order alone gives about 1e-5)."""
    model = PFNL(num_blocks=2, generator=torch.Generator().manual_seed(0)).cuda()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("bias"):
                p.copy_(_randn(gen, *p.shape, scale=0.05))
    x = torch.rand((2, 7, 16, 16, 3), generator=gen, device="cuda")
    gt = torch.rand((2, 1, 64, 64, 3), generator=gen, device="cuda")
    grads = {}
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        reset_launches()
        loss = charbonnier(model(x, plain=plain), gt)
        loss.backward()
        grads[plain] = (loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()})
        if not plain:
            assert dict(launches) == {"pfrb_a": 2, "pfrb_b": 2, "pfnl_tail": 1,
                                      "pfrb_bwd_b": 2, "pfrb_bwd_a": 2}
    assert dict(launches) == {}
    assert abs(grads[False][0] - grads[True][0]) <= 1e-5 * grads[True][0]
    for k, gp in grads[True][1].items():
        gk = grads[False][1][k]
        assert ((gk - gp).norm() / gp.norm()).item() <= 1e-3, k


def test_wrappers_refuse_to_cut_the_graph(gen):
    feat = _randn(gen, 1, 3, 8, 8, 64)
    p = _pfrb_params(gen, 3)
    w1 = p[0].clone().requires_grad_()
    with pytest.raises(RuntimeError, match="autograd"):
        pfrb_a(feat, w1, *p[1:4])
    with pytest.raises(RuntimeError, match="autograd"):
        pfrb_a(feat.clone().requires_grad_(), *p[:4])
    with torch.no_grad():
        pfrb_a(feat, w1, *p[1:4])                      # inference is not affected


def test_nonlocal_kernel_has_no_backward(gen):
    """Above the dense limit kernel 1 runs, and has no backward to give."""
    block = NonLocalBlock(84).cuda()
    x = torch.rand((1, 65, 64, 84), generator=gen, device="cuda")
    with pytest.raises(NotImplementedError):
        block(x)                                       # its parameters require grad
    reset_launches()
    with torch.no_grad():
        assert block(x).shape == x.shape
    assert dict(launches) == {"nonlocal_flash": 1}


def test_wrappers_reject_what_the_kernels_do_not_take(gen):
    feat = _randn(gen, 1, 3, 8, 8, 64)
    p = _pfrb_params(gen, 3)
    with pytest.raises(TypeError):
        pfrb_a(feat.half(), *p[:4])
    with pytest.raises(ValueError):
        pfrb_a(feat.transpose(2, 3), *p[:4])           # not contiguous
    with pytest.raises(ValueError):
        pfrb_a(feat[..., :32].contiguous(), *p[:4])    # not 64 channels
    with pytest.raises(ValueError):
        nonlocal_flash(*(_randn(gen, 1, 10, 128) for _ in range(3)))  # D > 96
    with pytest.raises(ValueError):
        pfnl_tail(feat, p[0], p[1], p[2], p[3])        # wrong merge kernel shape


def _flows(gen, b, h, w, r):
    """Flows in [-r, r], the bound met at two corners, one flow beyond it."""
    uv = (torch.rand((b, h, w, 2), generator=gen, device="cuda") * 2 - 1) * r
    uv[0, 0, 0] = torch.tensor([r, -r])
    uv[-1, -1, -1] = torch.tensor([-r, r])
    uv[0, h // 2, w // 2] = torch.tensor([2.6 * r, -1.3 * r])
    return uv


# the output tiles of kernels 7 (pixels) and 8 (LR cells), rows x columns
K7_TILE, K8_TILE = (16, 64), (16, 32)


def _tile_edge_flows(gen, b, h, w, r, tile):
    """_flows, plus flows at the bound across every tile boundary (the
    last row / column of a tile moved forward, the first moved back) and
    out of all four corners, so that taps and folds cross tiles."""
    uv = _flows(gen, b, h, w, r)
    th, tw = tile
    for y in range(th, h, th):
        uv[:, y - 1, :, 1], uv[:, y, :, 1] = r, -r
    for x in range(tw, w, tw):
        uv[:, :, x - 1, 0], uv[:, :, x, 0] = r, -r
    for y, x, sy, sx in ((0, 0, -1, -1), (0, -1, -1, 1), (-1, 0, 1, -1), (-1, -1, 1, 1)):
        uv[:, y, x] = torch.tensor([sx * r, sy * r], dtype=uv.dtype)
    return uv


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,r", [((3, 1, 37, 45), 2), ((2, 3, 20, 70), 1), ((1, 4, 9, 5), 2),
                                     ((2, 1, 15, 63), 2), ((2, 1, 17, 65), 2),
                                     ((1, 1, 31, 127), 1), ((1, 1, 33, 129), 1),
                                     ((1, 1, 3, 2), 2), ((2, 2, 2, 3), 4),
                                     ((1, 2, 17, 65), 1), ((1, 3, 33, 129), 1),
                                     ((2, 3, 20, 70), 0), ((1, 1, 15, 63), 0),
                                     ((1, 4, 19, 70), 4)])
def test_bounded_splat_kernel(gen, dtype, shape, r):
    """Kernel 7 against its plain version at ragged tiles (one below and
    one above a tile multiple, an image smaller than the halo, C 1-4, R
    0-4), flows at the bound across tile boundaries and out of the
    corners; bitwise equal over two launches."""
    b, c, h, w = shape
    im = torch.rand((b, h, w, c), generator=gen, device="cuda").to(dtype)
    uv = _tile_edge_flows(gen, b, h, w, max(r, 1), K7_TILE).to(dtype)
    got = bounded_splat(im, uv, r)
    _assert_close(got, forward_warp_local_ref(im, uv, r), dtype)
    assert torch.equal(got, bounded_splat(im, uv, r))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape,r", [((3, 20, 37), 2), ((1, 7, 5), 2),
                                     ((2, 15, 31), 2), ((2, 17, 33), 2), ((1, 31, 63), 1),
                                     ((1, 33, 65), 1), ((1, 2, 3), 2), ((2, 3, 2), 4),
                                     ((2, 17, 33), 0), ((1, 20, 40), 4)])
def test_spmc_splat_kernel(gen, dtype, shape, r):
    """Kernel 8 against its plain version at ragged tiles (one below and
    one above a tile multiple, an image smaller than the halo, R 0-4),
    flows at the bound across tile boundaries and out of the corners;
    bitwise equal over two launches."""
    b, h, w = shape
    im = torch.rand((b, h, w, 1), generator=gen, device="cuda").to(dtype)
    uv = _tile_edge_flows(gen, b, h, w, max(r, 1), K8_TILE).to(dtype)
    got = spmc_splat(im, uv, 4, r)
    _assert_close(got, forward_warp_local_spmc(im, uv, 4, r), dtype)
    assert torch.equal(got, spmc_splat(im, uv, 4, r))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("offset", [8, 1])
def test_splat_kernels_read_only_their_inputs(gen, dtype, offset):
    """im and uv as views into NaN-filled allocations, 16-byte aligned
    (offset 8, cp.async staging) or not (offset 1, element-wise staging):
    halo sources outside the image are never read, and the output is
    right."""
    for (b, c, h, w), r in (((2, 3, 17, 65), 1), ((1, 1, 15, 63), 2)):
        im = torch.rand((b, h, w, c), generator=gen, device="cuda").to(dtype)
        uv = _tile_edge_flows(gen, b, h, w, r, K7_TILE).to(dtype)
        got = bounded_splat(_nan_view(im, offset), _nan_view(uv, offset), r)
        assert torch.isfinite(got).all()
        _assert_close(got, forward_warp_local_ref(im, uv, r), dtype)
    for (b, h, w), r in (((2, 17, 33), 2), ((1, 15, 31), 1)):
        im = torch.rand((b, h, w, 1), generator=gen, device="cuda").to(dtype)
        uv = _tile_edge_flows(gen, b, h, w, r, K8_TILE).to(dtype)
        got = spmc_splat(_nan_view(im, offset), _nan_view(uv, offset), 4, r)
        assert torch.isfinite(got).all()
        _assert_close(got, forward_warp_local_spmc(im, uv, 4, r), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cls,want", [(VESPCN, {"bounded_splat": 1}),
                                      (MCResNet, {"bounded_splat": 1}),
                                      (LTDVSR, {"bounded_splat": 1}),
                                      (DRVSR, {"spmc_splat": 1})])
def test_y_family_kernel_path_matches_plain_path(gen, dtype, cls, want):
    """A Y family's serving forward: its splat kernel launched once per
    batch, against plain=True (relative L2)."""
    model = cls(dtype=dtype, generator=torch.Generator().manual_seed(0)).cuda().eval()
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith(("bias", "alpha")):
                p.copy_(_randn(gen, *p.shape, scale=0.1))
    x = torch.rand((2, model.num_frames, 36, 44, 3), generator=gen, device="cuda")
    kw = model.serve_kwargs
    reset_launches()
    with torch.inference_mode():
        got = model(x, **kw)["sr"]
        assert dict(launches) == want
        ref = model(x, plain=True, **kw)["sr"]
    assert dict(launches) == want
    assert got.shape == (2, 1, 144, 176, 1) and torch.isfinite(got).all()
    err = ((got - ref).norm() / ref.norm()).item()
    assert err <= TOL[dtype], err


def test_splat_wrappers_reject_what_the_kernels_do_not_take(gen):
    im = torch.rand((1, 8, 8, 1), generator=gen, device="cuda")
    uv = _flows(gen, 1, 8, 8, 2)
    with pytest.raises(TypeError):
        bounded_splat(im, uv.bfloat16(), 2)                   # mixed dtypes
    with pytest.raises(ValueError):
        bounded_splat(im.expand(1, 8, 8, 5).contiguous(), uv, 2)  # C > 4
    with pytest.raises(ValueError):
        bounded_splat(im.transpose(1, 2), uv, 2)               # not contiguous
    with pytest.raises(ValueError):
        spmc_splat(im, uv, 2, 2)                               # scale other than 4
    with pytest.raises(RuntimeError, match="autograd"):
        spmc_splat(im.clone().requires_grad_(), uv, 4, 2)
    bound = _build.splat_max_disp()
    assert bound >= 4                                          # the halo holds R up to 4
    with pytest.raises(ValueError):
        bounded_splat(im, uv, bound + 1)                       # R beyond the tile's halo
    with pytest.raises(ValueError):
        spmc_splat(im, uv, 4, bound + 1)


def _bounded_flows(gen, b, h, w, r):
    """Flows within [-r, r] (a flow beyond the bound loses taps in the
    forward that the gather adjoint still reads), the bound met at two
    corners."""
    uv = (torch.rand((b, h, w, 2), generator=gen, device="cuda") * 2 - 1) * r
    uv[0, 0, 0] = torch.tensor([r, -r])
    uv[-1, -1, -1] = torch.tensor([-r, r])
    return uv


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,c,r", [("bounded", 1, 2), ("bounded", 3, 1), ("spmc", 1, 2),
                                      ("spmc", 1, 1)])
def test_splats_under_grad_launch_their_kernels(gen, dtype, kind, c, r):
    """forward_warp_local / forward_warp_spmc under autograd on the card:
    the kernel launches once (BoundedSplat / SpmcSplat), its output is the
    kernel's, and the gradients of im and uv are plain autograd's through
    the plain splat; the raw wrapper still raises under grad."""
    b, h, w = 2, 20, 70
    im0 = torch.rand((b, h, w, c), generator=gen, device="cuda").to(dtype)
    uv0 = _bounded_flows(gen, b, h, w, r).to(dtype)
    shape = (b, h, w, c) if kind == "bounded" else (b, 4 * h, 4 * w, c)
    g = torch.randn(shape, generator=gen, device="cuda").to(dtype)
    if kind == "bounded":
        fn, plain, raw = forward_warp_local, forward_warp_local_ref, bounded_splat
    else:
        fn = lambda i, u, r: forward_warp_spmc(i, u, 4, r)  # noqa: E731
        plain = lambda i, u, r: forward_warp_local_spmc(i, u, 4, r)  # noqa: E731
        raw = lambda i, u, r: spmc_splat(i, u, 4, r)  # noqa: E731
    outs = {}
    for path, f in (("kernel", fn), ("plain", plain)):
        im, uv = im0.clone().requires_grad_(), uv0.clone().requires_grad_()
        reset_launches()
        out = f(im, uv, r)
        assert out.requires_grad
        out.backward(g)
        outs[path] = (out.detach(), im.grad, uv.grad, dict(launches))
    assert outs["kernel"][3] == {f"{kind}_splat": 1} and outs["plain"][3] == {}
    with torch.no_grad():
        assert torch.equal(outs["kernel"][0], raw(im0, uv0, r))
    _assert_close(outs["kernel"][1:3], outs["plain"][1:3], dtype)
    with pytest.raises(RuntimeError, match="autograd"):
        raw(im0.clone().requires_grad_(), uv0, r)


@pytest.mark.parametrize("family,want", [("vespcn", {"bounded_splat": 1}),
                                         ("ltdvsr", {"bounded_splat": 1}),
                                         ("drvsr", {"spmc_splat": 1, "bounded_splat": 1}),
                                         ("frvsr", {"bounded_splat": 4})])
def test_flow_family_gradients_kernel_path_match_plain_path(gen, family, want):
    """One float32 training step of a flow family (FRVSR at 3 frames: K7
    twice a frame after the first) through K7/K8 and their adjoints against
    pure autograd on the plain path: the joint loss and every parameter
    gradient within 1e-3 relative L2."""
    from pfnl_tpu_torch.train.losses import LOSS_REGISTRY

    kw = {"num_frames": 3, "mf": 16, "num_blocks": 2} if family == "frvsr" else {}
    model = seeded_model(family, torch.float32, 0, **kw).train()
    t = model.num_frames
    x = torch.rand((2, t, 16, 20, 3), generator=gen, device="cuda")
    gt = torch.rand((2, t if family == "frvsr" else 1, 64, 80, 3), generator=gen, device="cuda")
    res = {}
    for plain in (False, True):
        model.zero_grad(set_to_none=True)
        reset_launches()
        loss = LOSS_REGISTRY[family](model(x, plain=plain), gt, x)["loss"]
        loss.backward()
        res[plain] = (loss.item(), {k: p.grad.clone() for k, p in model.named_parameters()},
                      dict(launches))
    assert res[False][2] == want and res[True][2] == {}
    assert abs(res[False][0] - res[True][0]) <= 1e-5 * abs(res[True][0])
    for k, gp in res[True][1].items():
        assert ((res[False][1][k] - gp).norm() / gp.norm()).item() <= 1e-3, k


def _duf_block_params(gen, f, g, mode):
    return BlockParams(sa=torch.rand(f, generator=gen, device="cuda") + 0.5,
                       oa=_randn(gen, f, scale=0.3), wa=_randn(gen, f, f, scale=f ** -0.5),
                       sb=torch.rand(f, generator=gen, device="cuda") + 0.5,
                       ob=_randn(gen, f, scale=0.3),
                       wb=_randn(gen, 3, 3, 3, f, g, scale=(27 * f) ** -0.5),
                       bb=_randn(gen, g, scale=0.1), mode=mode)


def _bits(x):
    return x.view(torch.int16 if x.element_size() == 2 else torch.int32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("extra", [8, 3])
@pytest.mark.parametrize("f,g,mode,lo,hi", [(64, 16, "thw", 0, 7), (96, 16, "thw", 0, 5),
                                            (80, 32, "hw", 1, 6), (48, 32, "thw", 0, 3),
                                            (80, 16, "thw", 0, 7), (400, 16, "hw", 2, 7),
                                            (36, 16, "thw", 1, 6)])
def test_duf_block_kernel(gen, dtype, f, g, mode, lo, hi, extra):
    """Kernel 9 at ragged tiles on a buffer that holds NaN wherever the block
    may not read (other planes, channels >= F) and a NaN scratch: the new
    channels are finite and within tolerance of the plain version, and
    every other element of the buffer is bitwise unchanged.  F 80 and 400
    are ragged against the bf16 product's 128-wide N tile; a buffer of F+G+3
    channels (not a multiple of 8) takes its element-wise staging, and F 36
    also the product's element-wise stores of `a`."""
    p = _duf_block_params(gen, f, g, mode)
    buf = torch.full((2, 7, 13, 21, f + g + extra), float("nan"), device="cuda").to(dtype)
    buf[:, lo:hi, :, :, :f] = torch.rand((2, hi - lo, 13, 21, f), generator=gen,
                                         device="cuda").to(dtype)
    scratch = torch.full((2 * 7 * 13 * 21 * f,), float("nan"), device="cuda").to(dtype)
    got, ref = buf.clone(), buf.clone()
    reset_launches()
    dense_block(got, p, lo, hi, scratch)
    assert dict(launches) == {"duf_block": 1}
    dense_block_ref(ref, p, lo, hi)
    olo, ohi = (lo, hi) if mode == "thw" else (lo + 1, hi - 1)
    new = (slice(None), slice(olo, ohi), slice(None), slice(None), slice(f, f + g))
    assert torch.isfinite(got[new]).all()
    _assert_close(got[new], ref[new], dtype)
    written = torch.zeros(buf.shape, dtype=torch.bool, device="cuda")
    written[new] = True
    assert torch.equal(_bits(got)[~written], _bits(buf)[~written])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pad_t", [True, False])
@pytest.mark.parametrize("g", [16, 32])
@pytest.mark.parametrize("f", [40, 64, 432])
def test_duf_dense_kernel(gen, dtype, pad_t, f, g):
    """Kernel 10 at ragged tiles (13 x 21 against 8 x 32 / 8 x 16) and a
    ragged channel chunk (F = 40), SAME and VALID in T."""
    x = torch.rand((2, 5, 13, 21, f), generator=gen, device="cuda").to(dtype)
    wk = _randn(gen, 3, 3, 3, f, g, scale=(27 * f) ** -0.5)
    reset_launches()
    got = duf_dense(x, wk, pad_t)
    assert dict(launches) == {"duf_dense": 1}
    _assert_close(got, conv3x3x3_ref(x, wk, pad_t), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("pad_t", [True, False])
@pytest.mark.parametrize("offset", [8, 1])
def test_duf_dense_reads_only_its_input(gen, dtype, pad_t, offset):
    """x as a view into a NaN-filled allocation, 16-byte aligned (offset 8)
    or not (offset 1): halo pixels and pad planes are never read."""
    x = torch.rand((2, 5, 13, 21, 40), generator=gen, device="cuda").to(dtype)
    wk = _randn(gen, 3, 3, 3, 40, 16, scale=(27 * 40) ** -0.5)
    got = duf_dense(_nan_view(x, offset), wk, pad_t)
    assert torch.isfinite(got).all()
    _assert_close(got, conv3x3x3_ref(x, wk, pad_t), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kernel", ["nonlocal_flash", "duf_dense", "pfrb_a", "pfrb_b",
                                    "pfnl_tail", "duf_block"])
def test_kernels_bitwise_equal_over_two_launches(gen, dtype, kernel):
    """Kernels 1-4, 9 and 10 sum in a fixed order, with no atomics."""
    if kernel == "nonlocal_flash":
        args = _attention_inputs(gen, dtype, 2, 1000, 777, 84)
        fn = nonlocal_flash
    elif kernel == "pfnl_tail":
        args = (_randn(gen, 2, 7, 37, 70, 64, scale=0.5).to(dtype),
                _randn(gen, 3, 3, 7 * 64, 48, scale=0.02), _randn(gen, 48, scale=0.1),
                _randn(gen, 3, 3, 12, 12, scale=0.1), _randn(gen, 12, scale=0.1))
        fn = pfnl_tail
    elif kernel == "duf_block":
        buf = torch.rand((2, 7, 37, 70, 160), generator=gen, device="cuda").to(dtype)
        p = _duf_block_params(gen, 144, 16, "thw")
        args = (buf,)
        fn = lambda b: dense_block(b.clone(), p, 0, 7)  # noqa: E731  (in place: a fresh copy)
    elif kernel == "duf_dense":
        args = (torch.rand((2, 7, 37, 70, 64), generator=gen, device="cuda").to(dtype),
                _randn(gen, 3, 3, 3, 64, 16, scale=(27 * 64) ** -0.5), True)
        fn = duf_dense
    else:
        feat = _randn(gen, 2, 7, 37, 70, 64, scale=0.5).to(dtype)
        w1, b1, wfuse, bfuse, w2f, w2b, b2 = _pfrb_params(gen, 7)
        if kernel == "pfrb_a":
            args, fn = (feat, w1, b1, wfuse, bfuse), pfrb_a
        else:
            args, fn = (feat, *pfrb_a_ref(feat, w1, b1, wfuse, bfuse), w2f, w2b, b2), pfrb_b
    got, again = fn(*args), fn(*args)
    got, again = (x if isinstance(x, tuple) else (x,) for x in (got, again))
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_duf_dense_backward_matches_plain_autograd(gen):
    """conv3x3x3 on a tensor that requires grad: kernel 10 forward, the
    plain conv's vector-Jacobian product backward."""
    x = torch.rand((1, 5, 9, 11, 32), generator=gen, device="cuda")
    wk = _randn(gen, 3, 3, 3, 32, 16, scale=0.05)
    grads = []
    for fn in (conv3x3x3, conv3x3x3_ref):
        xg, wg = x.clone().requires_grad_(), wk.clone().requires_grad_()
        reset_launches()
        (fn(xg, wg, True) ** 2).sum().backward()
        grads.append((xg.grad, wg.grad, dict(launches)))
    assert grads[0][2] == {"duf_dense": 1} and grads[1][2] == {}
    _assert_close(grads[0][:2], grads[1][:2], torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
def test_duf_kernel_paths_match_plain_path(gen, dtype):
    """DUF-16L's forward: kernel 9 once per dense block ("auto", no grad), or
    kernel 10 once per growth conv ("pallas"), against plain=True."""
    model = seeded_model("duf", dtype, 0, layers=16)
    x = torch.rand((2, 7, 20, 36, 3), generator=gen, device="cuda")
    paths = {}
    for impl, want in (("auto", {"duf_block": 6}), ("pallas", {"duf_dense": 6})):
        m = DUF(layers=16, dtype=dtype, conv3d_impl=impl).cuda().eval()
        m.load_state_dict(model.state_dict())
        reset_launches()
        with torch.inference_mode():
            paths[impl] = m(x)
            assert dict(launches) == want
            ref = m(x, plain=True)
        assert dict(launches) == want
    assert ref.shape == (2, 1, 80, 144, 3)
    for got in paths.values():
        assert torch.isfinite(got).all()
        err = ((got - ref).norm() / ref.norm()).item()
        assert err <= TOL[dtype], err


def test_duf_wrappers_refuse_what_the_kernels_do_not_take(gen):
    p = _duf_block_params(gen, 64, 16, "thw")
    buf = torch.rand((1, 3, 8, 8, 96), generator=gen, device="cuda")
    with pytest.raises(RuntimeError, match="autograd"):
        dense_block(buf, p._replace(wa=p.wa.clone().requires_grad_()), 0, 3)
    with pytest.raises(ValueError):
        dense_block(buf[..., :72].contiguous(), p, 0, 3)              # F + G > C
    with pytest.raises(ValueError):
        dense_block(buf, p._replace(mode="hw"), 0, 2)                 # no output plane
    with pytest.raises(TypeError):
        dense_block(buf.half(), p, 0, 3)
    with pytest.raises(ValueError):
        duf_dense(buf[..., :64].contiguous(), _randn(gen, 3, 3, 3, 64, 24), True)  # G 24
    with pytest.raises(RuntimeError, match="autograd"):
        duf_dense(buf.clone().requires_grad_(), _randn(gen, 3, 3, 3, 96, 16), True)



def test_duf_training_kernel_10_gradients_match_plain_autograd(gen):
    """DUF-16L in training mode, float32, conv3d_impl="pallas": kernel 10
    once per growth conv under autograd (`Conv3x3x3`), no kernel 9; against
    plain autograd from the same weights, the Huber loss, the BatchNorm
    buffers after the step (1e-5), and every parameter's gradient within
    1e-3 of its L2 norm or within 3 times the most that float32 alone moves
    it on the plain path, whichever is larger: the batch order reversed
    (the same function summed in another order), or PyTorch's native conv
    in place of cuDNN's.  The floor takes nothing from the kernel path, so
    that a fault that depends on where a sample sits in the batch cannot
    widen its own limit.  A training BatchNorm's backward amplifies
    rounding: kernel 10's forward is as close to float64 as cuDNN's (7e-7
    to 2e-6), yet a few of these gradients differ by 2e-3.  The biases a
    BatchNorm cancels, 0 in exact arithmetic, are measured against the
    median gradient norm."""
    from pfnl_tpu_torch.train.losses import duf_loss

    base = seeded_model("duf", torch.float32, 0, layers=16)
    x = torch.rand((2, 7, 16, 16, 3), generator=gen, device="cuda")
    gt = torch.rand((2, 1, 64, 64, 3), generator=gen, device="cuda")
    res = {}
    for plain, rev, cudnn in ((False, False, True), (True, False, True), (True, True, True),
                              (True, False, False)):
        m = DUF(layers=16, conv3d_impl="pallas").cuda().train()
        m.load_state_dict(base.state_dict())
        xi, gi = (x.flip(0), gt.flip(0)) if rev else (x, gt)
        reset_launches()
        with torch.backends.cudnn.flags(enabled=cudnn, allow_tf32=False):
            loss = duf_loss({"sr": m(xi, plain=plain)}, gi, xi)["loss"]
            loss.backward()
        res[plain, rev, cudnn] = (loss.item(), {k: p.grad for k, p in m.named_parameters()},
                                  dict(m.named_buffers()), dict(launches))
    kern, plain = res[False, False, True], res[True, False, True]
    assert kern[3] == {"duf_dense": 6} and plain[3] == {}
    assert kern[0] == pytest.approx(plain[0], rel=1e-5)
    median = sorted(g.norm().item() for g in plain[1].values())[len(plain[1]) // 2]
    for k, g in plain[1].items():
        err = (kern[1][k] - g).norm().item()
        noise = max((res[True, True, True][1][k] - g).norm().item(),
                    (res[True, False, False][1][k] - g).norm().item())
        scale = median if bn_cancelled_bias(k) else g.norm().item()
        assert err <= max(1e-3 * scale, 3 * noise), (k, err, noise)
    for k, b in plain[2].items():
        torch.testing.assert_close(kern[2][k], b, rtol=1e-5, atol=1e-5, msg=k)


def test_duf_train_mode_forward_under_no_grad_takes_the_plain_backbone(gen):
    """The auto rule reads the mode, as JAX reads is_train: a training-mode
    forward under no_grad on the card runs the plain backbone (kernel 9
    folds the eval statistics) and updates the BatchNorm buffers once; in
    eval mode the same call launches kernel 9 once per dense block."""
    m = seeded_model("duf", torch.float32, 0, layers=16).train()
    x = torch.rand((1, 7, 12, 12, 3), generator=gen, device="cuda")
    reset_launches()
    with torch.no_grad():
        sr = m(x)
    assert dict(launches) == {} and torch.isfinite(sr).all()
    assert all(b.item() == 1.0 for k, b in m.named_buffers() if k.endswith("local_step"))
    m.eval()
    with torch.no_grad():
        m(x)
    assert dict(launches) == {"duf_block": 6}


def test_flownetc_on_the_card_matches_the_cpu(gen):
    """FlowNet-C (plain PyTorch: its correlation is XLA in the JAX package,
    not a kernel) on the card against the same weights on the CPU, float32
    with TF32 off, at a size that is not a multiple of 64."""
    from pfnl_tpu_torch.models.flownet import FlowNetC

    model = FlowNetC(generator=torch.Generator().manual_seed(0)).eval()
    a, b = (torch.rand((2, 72, 100, 3), generator=gen, device="cuda") for _ in range(2))
    with torch.no_grad():
        ref = model(a.cpu(), b.cpu())
        got = model.cuda()(a, b).cpu()
    assert got.shape == (2, 72, 100, 2)
    assert (got - ref).abs().max() <= 1e-4 * ref.abs().max()


# --- the kernels as torch.library custom ops; export; multi-GPU at world size 1 ------------

def _op_args(gen, name, dtype):
    """torch.ops.pfnl.<name>'s arguments at a small shape, as its wrapper
    hands them over (weights cast as the entry for dtype reads them)."""
    from pfnl_tpu_torch.ops.cuda.pfrb_bwd import _conv_t_weight
    from pfnl_tpu_torch.ops.pfrb_ref import fold_d2s_conv

    t = lambda *s, scale=0.1: _randn(gen, *s, scale=scale).to(dtype)  # noqa: E731
    kw = lambda w: _build.kernel_weight(w, dtype, "cuda")  # noqa: E731
    f32 = lambda w: _build.weight_f32(w, dtype, "cuda")  # noqa: E731
    feat, w3, b = t(1, 3, 8, 8, 64), _randn(gen, 3, 3, 64, 64, scale=0.05), _randn(gen, 64)
    base = t(1, 8, 8, 64)
    if name == "nonlocal_flash":
        return (t(1, 64, 32, scale=1.0), t(1, 80, 32, scale=1.0), t(1, 80, 24, scale=1.0))
    if name == "pfrb_a":
        return (feat, kw(w3), f32(b), kw(_randn(gen, 3, 64, 64, scale=0.05)), f32(b))
    if name == "pfrb_b":
        return (feat, feat, base, kw(w3), kw(w3), f32(b))
    if name == "pfnl_tail":
        km2 = _randn(gen, 3, 3, 12, 12, scale=0.1)
        return (feat, kw(_randn(gen, 3, 3, 192, 48, scale=0.02)), f32(_randn(gen, 48)),
                fold_d2s_conv(kw(km2)).contiguous(), f32(_randn(gen, 12)).repeat(4).contiguous())
    if name == "pfrb_bwd_b":
        return (feat, feat, base, _conv_t_weight(w3, dtype, "cuda"),
                _conv_t_weight(w3, dtype, "cuda"))
    if name == "pfrb_bwd_a":
        return (feat, feat, feat, _conv_t_weight(w3, dtype, "cuda"))
    if name == "bounded_splat":
        return (t(2, 16, 16, 3, scale=1.0), (torch.rand((2, 16, 16, 2), generator=gen,
                                                        device="cuda") * 4 - 2).to(dtype), 2)
    if name == "spmc_splat":
        return (t(2, 16, 16, 1, scale=1.0), (torch.rand((2, 16, 16, 2), generator=gen,
                                                        device="cuda") * 4 - 2).to(dtype), 4, 2)
    if name == "duf_block":
        p = _duf_block_params(gen, 16, 16, "thw")
        buf = t(1, 3, 8, 8, 32, scale=1.0)
        return (buf, torch.empty(3 * 64 * 16, dtype=dtype, device="cuda"),
                *(v.float().contiguous() for v in (p.sa, p.oa)), kw(p.wa),
                *(v.float().contiguous() for v in (p.sb, p.ob)), kw(p.wb), p.bb.float(),
                0, 3, True)
    if name == "duf_dense":
        return (t(1, 5, 8, 8, 16, scale=1.0), kw(_randn(gen, 3, 3, 3, 16, 16, scale=0.1)), False)
    raise KeyError(name)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", ["nonlocal_flash", "pfrb_a", "pfrb_b", "pfnl_tail",
                                  "pfrb_bwd_b", "pfrb_bwd_a", "bounded_splat", "spmc_splat",
                                  "duf_block", "duf_dense"])
def test_opcheck(gen, name, dtype):
    """torch.library.opcheck on each pfnl op: the schema (duf_block mutates
    its buffer and scratch and says so, the others mutate nothing), the fake
    implementation against the kernel's outputs, and the op under
    AOTAutograd with dynamic shapes."""
    torch.library.opcheck(getattr(torch.ops.pfnl, name).default, _op_args(gen, name, dtype))


def test_pfnl_artifact_on_the_card_launches_its_kernels_and_matches_serve(gen):
    """PFNL, 2 blocks, bf16, LR 130x132 (65x66 non-local positions, so
    kernel 1 runs): the exported program holds one pfnl node a launch,
    export launches one eager call's kernels (tracing none), the loaded
    artifact launches kernels 1-4 once a node and gives eager serve's
    frames (uint8 within 1 step, relative L2 1e-3: the same kernels in the
    same order), and refuses a CPU input."""
    from collections import Counter

    from pfnl_tpu_torch.infer.export import export_model, load_exported
    from pfnl_tpu_torch.infer.predictor import serve, to_uint8

    model = PFNL(num_blocks=2, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    x = torch.rand((2, 7, 130, 132, 3), generator=gen, device="cuda")
    want = {"nonlocal_flash": 1, "pfrb_a": 2, "pfrb_b": 2, "pfnl_tail": 1}
    reset_launches()
    blob = export_model(model, 2, 7, (130, 132), model_name="pfnl")
    assert dict(launches) == want  # the eager call before the trace
    fn = load_exported(blob)
    reset_launches()
    nodes = Counter(n.target.__name__.split(".")[0] for n in fn.program.graph.nodes
                    if n.op == "call_function" and "pfnl" in str(n.target))
    assert dict(nodes) == want
    out = fn(x)
    assert dict(launches) == want
    with torch.inference_mode():
        ref = serve(model, x)
    assert out.shape == (2, 1, 520, 528, 3)
    assert ((out[:, 0] - ref).norm() / ref.norm()).item() <= 1e-3
    assert (to_uint8(out[:, 0]).int() - to_uint8(ref).int()).abs().max().item() <= 1
    assert fn.meta["device"] == "cuda:0"
    with pytest.raises(ValueError):
        fn(x.cpu())


def test_nonlocal_attention_sp_at_world_size_1_is_kernel_1(gen):
    """Over a world-1 NCCL group the gathered keys are the rank's own, and
    the attention is one kernel-1 launch, bitwise nonlocal_flash's."""
    import socket

    import torch.distributed as dist

    from pfnl_tpu_torch.parallel.nonlocal_sp import nonlocal_attention_sp

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}", world_size=1, rank=0)
    try:
        th, ph, g = _attention_inputs(gen, torch.bfloat16, 2, 1000, 1000, 84)
        reset_launches()
        with torch.no_grad():
            got = nonlocal_attention_sp(th, ph, g)
        assert dict(launches) == {"nonlocal_flash": 1}
        with torch.no_grad():
            assert torch.equal(got, nonlocal_flash(th, ph, g))
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("data,space", [(1, 2), (2, 2)])
def test_sharded_forward_runs_kernels_1_to_4_on_every_band(gen, data, space):
    """PFNL, 2 blocks, bf16, LR 130x132 (65x66 non-local positions, so the
    unsharded forward runs kernel 1 too) over [cuda:0] * data * space: kernel
    1 once a band, kernels 2 and 3 once a block a band, kernel 4 once a band,
    and the unsharded kernel path's SR within relative L2 1e-3 with conv0 on
    PyTorch's own convolution on both sides (cuDNN picks another conv0
    algorithm for a band than for the whole image)."""
    from pfnl_tpu_torch.parallel.spmd import sharded_forward

    model = PFNL(num_blocks=2, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    x = torch.rand((2 * data, 7, 130, 132, 3), generator=gen, device="cuda")
    fn = sharded_forward(model, ["cuda"] * (data * space), space=space)
    reset_launches()
    got = fn(x)
    cells = data * space
    assert dict(launches) == {"nonlocal_flash": cells, "pfrb_a": 2 * cells, "pfrb_b": 2 * cells,
                              "pfnl_tail": cells}
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=False):
        got = fn(x)
        ref = model(x)
    assert got.shape == ref.shape == (2 * data, 1, 520, 528, 3)
    assert ((got - ref).norm() / ref.norm()).item() <= 1e-3


# bench.main's launches a serving forward of each family at LR 132x132 (66x66 = 4356 non-local
# positions, above the dense limit, so PFNL runs kernel 1): DRVSR `last_only`, FRVSR's 10
# streamed frames, DUF-52L in eval mode
BENCH_LAUNCHES = {"pfnl": {"nonlocal_flash": 1, "pfrb_a": 20, "pfrb_b": 20, "pfnl_tail": 1},
                  "vespcn": {"bounded_splat": 1}, "ltdvsr": {"bounded_splat": 1},
                  "mcresnet": {"bounded_splat": 1}, "drvsr": {"spmc_splat": 1},
                  "frvsr": {"bounded_splat": 9}, "duf": {"duf_block": 24}}


@pytest.mark.parametrize("model", list(BENCH_LAUNCHES))
def test_bench_main_launches_each_familys_kernels(gen, model, capsys):
    """`pfnl_tpu_torch.bench.main` at batch 1, 2 steps: a warm-up call and
    three timed calls of 2 forwards, each launching the family's kernels and
    no other, and one record with a positive rate."""
    import json

    from pfnl_tpu_torch import bench

    reset_launches()
    fps = bench.main(model, "132x132", bench._MODEL_FRAMES[model], 2, 1, "bfloat16", "cuda")
    assert dict(launches) == {k: 8 * v for k, v in BENCH_LAUNCHES[model].items()}
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert fps > 0 and rec["value"] == round(fps, 3)
