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

from pfnl_tpu_torch.models.pfnl import PFNL
from pfnl_tpu_torch.ops.cuda import launches, reset_launches
from pfnl_tpu_torch.ops.cuda.nonlocal_flash import nonlocal_flash
from pfnl_tpu_torch.ops.cuda.pfnl_tail import pfnl_tail
from pfnl_tpu_torch.ops.cuda.pfrb import pfrb_a, pfrb_b
from pfnl_tpu_torch.ops.nonlocal_attn import nonlocal_attention_chunked
from pfnl_tpu_torch.ops.pfrb_ref import pfnl_tail_ref, pfrb_a_ref, pfrb_b_ref

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


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n,m,d", [(2, 256, 256, 84), (1, 300, 200, 30), (1, 1000, 1000, 96)])
def test_nonlocal_flash_kernel(gen, dtype, b, n, m, d):
    theta = torch.rand((b, n, d), generator=gen, device="cuda").to(dtype)
    phi = torch.rand((b, m, d), generator=gen, device="cuda").to(dtype)
    g = _randn(gen, b, m, d).to(dtype)
    _assert_close(nonlocal_flash(theta, phi, g), nonlocal_attention_chunked(theta, phi, g), dtype)


def _pfrb_params(gen, t, c=64):
    return (_randn(gen, 3, 3, c, c, scale=0.06), _randn(gen, c, scale=0.1),
            _randn(gen, t, c, c, scale=0.1), _randn(gen, c, scale=0.1),
            _randn(gen, 3, 3, c, c, scale=0.04), _randn(gen, 3, 3, c, c, scale=0.04),
            _randn(gen, c, scale=0.1))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 7, 9, 13), (2, 3, 20, 37)])
def test_pfrb_kernels(gen, dtype, shape):
    n, t, h, w = shape
    feat = _randn(gen, n, t, h, w, 64, scale=0.5).to(dtype)
    w1, b1, wfuse, bfuse, w2f, w2b, b2 = _pfrb_params(gen, t)
    i1, base = pfrb_a_ref(feat, w1, b1, wfuse, bfuse)
    _assert_close(pfrb_a(feat, w1, b1, wfuse, bfuse), (i1, base), dtype)
    _assert_close(pfrb_b(feat, i1, base, w2f, w2b, b2),
                  pfrb_b_ref(feat, i1, base, w2f, w2b, b2), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 7, 9, 13), (2, 3, 20, 37)])
def test_pfnl_tail_kernel(gen, dtype, shape):
    n, t, h, w = shape
    feat = _randn(gen, n, t, h, w, 64, scale=0.5).to(dtype)
    args = (feat, _randn(gen, 3, 3, t * 64, 48, scale=0.02), _randn(gen, 48, scale=0.1),
            _randn(gen, 3, 3, 12, 12, scale=0.1), _randn(gen, 12, scale=0.1))
    _assert_close(pfnl_tail(*args), pfnl_tail_ref(*args), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_pfnl_kernel_path_matches_plain_path(gen, dtype):
    """The whole forward, and the launches of one forward batch."""
    model = PFNL(num_blocks=2, dtype=dtype, generator=torch.Generator().manual_seed(0))
    model = model.cuda().eval()
    x = torch.rand((2, 7, 12, 18, 3), generator=gen, device="cuda")
    reset_launches()
    with torch.inference_mode():
        got = model(x)
        assert dict(launches) == {"nonlocal_flash": 1, "pfrb_a": 2, "pfrb_b": 2, "pfnl_tail": 1}
        ref = model(x, plain=True)
    assert dict(launches) == {"nonlocal_flash": 1, "pfrb_a": 2, "pfrb_b": 2, "pfnl_tail": 1}
    assert got.shape == (2, 1, 48, 72, 3) and torch.isfinite(got).all()
    err = ((got - ref).norm() / ref.norm()).item()
    assert err <= TOL[dtype], err


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
