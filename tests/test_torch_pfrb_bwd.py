"""Kernels 5 and 6's module and the chain under autograd: the port's PFRB
chain backward (`pfrb_chain` on CPU tensors, whose kernel wrappers take
their plain versions) against the JAX package's Pallas backward
`chain_bwd_pallas` (interpret mode) and `jax.grad` of its XLA chain; the
plain versions of kernels 5 and 6 against the steps of
`_chain_manual_bwd`; gradcheck of the chain and the tail Functions."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

torch.set_num_threads(2)

from pfnl_tpu.ops.pallas.pfrb_bwd import chain_bwd_pallas
from pfnl_tpu.ops.pallas.pfrb_pack import (_chain_pack_run, _conv_w_grad, _conv_x_grad,
                                           pick_rows, pick_tb)
from pfnl_tpu.ops.pallas.pfrb_xla import pfrb_chain_xla

from pfnl_tpu_torch.ops.cuda import launches
from pfnl_tpu_torch.ops.cuda.pfnl_tail import MergeTail
from pfnl_tpu_torch.ops.cuda.pfrb_bwd import pfrb_bwd_a, pfrb_bwd_b
from pfnl_tpu_torch.ops.pfrb_chain import PFRBChain, pfrb_chain
from pfnl_tpu_torch.ops.pfrb_ref import pfrb_bwd_a_ref, pfrb_bwd_b_ref

N, T, H, W, C = 1, 7, 10, 18, 64
SHAPES = [(3, 3, C, C), (C,), (T, C, C), (C,), (3, 3, C, C), (3, 3, C, C), (C,)]
PARAM_NAMES = ("W1", "b1", "Wfuse", "bfuse", "W2f", "W2b", "b2")


@pytest.fixture(scope="module")
def chain_case():
    """2 blocks at (1,7,10,18,64): the port's gradients and both JAX ones."""
    rng = np.random.default_rng(21)
    params = [tuple((rng.standard_normal(s) * 0.05).astype(np.float32) for s in SHAPES)
              for _ in range(2)]
    feat = (rng.standard_normal((N, T, H, W, C)) * 0.1).astype(np.float32)
    g = rng.standard_normal((N, T, H, W, C)).astype(np.float32)

    jparams = [tuple(jnp.asarray(a) for a in p) for p in params]
    _, (feats, i1s, bases) = _chain_pack_run(jnp.asarray(feat), jparams, collect=True)
    pallas = chain_bwd_pallas(feats, i1s, bases, jparams, jnp.asarray(g), H, W,
                              pick_rows(H), pick_tb(T))
    autodiff = jax.grad(lambda f, ps: jnp.sum(pfrb_chain_xla(f, ps) * jnp.asarray(g)),
                        argnums=(0, 1))(jnp.asarray(feat), jparams)

    tfeat = torch.from_numpy(feat).requires_grad_()
    tparams = [tuple(torch.from_numpy(a).requires_grad_() for a in p) for p in params]
    before = sum(launches.values())
    out = pfrb_chain(tfeat, tparams)
    (out * torch.from_numpy(g)).sum().backward()
    assert sum(launches.values()) == before  # CPU tensors launch no kernel
    port = (tfeat.grad.numpy(), [tuple(p.grad.numpy() for p in blk) for blk in tparams])
    return port, {"pallas": pallas, "autodiff": autodiff}


@pytest.mark.parametrize("ref", ["pallas", "autodiff"])
def test_chain_backward_matches_jax(chain_case, ref):
    (d_feat, d_params), want = chain_case[0], chain_case[1][ref]
    np.testing.assert_allclose(d_feat, np.asarray(want[0]), atol=1e-4)
    for k in range(2):
        for name, a, b in zip(PARAM_NAMES, d_params[k], want[1][k]):
            np.testing.assert_allclose(a, np.asarray(b), atol=2e-4, err_msg=f"block {k} {name}")


@pytest.fixture(scope="module")
def block_case():
    """One block's saved activations and cotangents at (2,3,9,13,64); the
    cotangent dz is small (0.05) so the 700-pixel bias sums stay near 1 and
    float32 summation order stays under atol."""
    rng = np.random.default_rng(5)
    n, t, h, w = 2, 3, 9, 13
    r = lambda *s: (rng.standard_normal(s) * 0.5).astype(np.float32)  # noqa: E731
    return dict(dz=r(n, t, h, w, C) * 0.1, i1=r(n, t, h, w, C), base=r(n, h, w, C),
                feat=r(n, t, h, w, C), g=r(n, t, h, w, C),
                w1=r(3, 3, C, C) * 0.1, w2f=r(3, 3, C, C) * 0.1, w2b=r(3, 3, C, C) * 0.1)


def _manual_bwd_b(c):
    """The steps of `_chain_manual_bwd` that kernel 5 computes (:487-493)."""
    n, t, h, w, _ = c["dz"].shape
    dz2 = jnp.asarray(c["dz"])
    dz2_4 = dz2.reshape(n * t, h, w, C)
    d_i1 = _conv_x_grad(dz2_4, jnp.asarray(c["w2f"])).reshape(dz2.shape)
    dz2_sum = jnp.sum(dz2.astype(jnp.float32), axis=1)
    d_base = _conv_x_grad(dz2_sum, jnp.asarray(c["w2b"]))
    d_w2f = _conv_w_grad(jnp.asarray(c["i1"]).reshape(n * t, h, w, C), dz2_4)
    d_w2b = _conv_w_grad(jnp.asarray(c["base"]), dz2_sum)
    d_b2 = jnp.sum(dz2, axis=(0, 1, 2, 3))
    return d_i1, d_base, d_w2f, d_w2b, d_b2


def _manual_bwd_a(c):
    """The steps of `_chain_manual_bwd` that kernel 6 computes (:501-505)."""
    n, t, h, w, _ = c["dz"].shape
    dz1 = jnp.asarray(c["dz"])
    dz1_4 = dz1.reshape(n * t, h, w, C)
    d_feat = jnp.asarray(c["g"]) + _conv_x_grad(dz1_4, jnp.asarray(c["w1"])).reshape(dz1.shape)
    d_w1 = _conv_w_grad(jnp.asarray(c["feat"]).reshape(n * t, h, w, C), dz1_4)
    return d_feat, d_w1, jnp.sum(dz1, axis=(0, 1, 2, 3))


@pytest.mark.parametrize("fn", [pfrb_bwd_b_ref, pfrb_bwd_b], ids=["plain", "wrapper"])
def test_bwd_b_matches_manual_backward(block_case, fn):
    c = {k: torch.from_numpy(v) for k, v in block_case.items()}
    got = fn(c["dz"], c["i1"], c["base"], c["w2f"], c["w2b"])
    for name, a, b in zip(("d_i1", "d_base", "dW2f", "dW2b", "db2"), got,
                          _manual_bwd_b(block_case)):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, err_msg=name)


@pytest.mark.parametrize("fn", [pfrb_bwd_a_ref, pfrb_bwd_a], ids=["plain", "wrapper"])
def test_bwd_a_matches_manual_backward(block_case, fn):
    c = {k: torch.from_numpy(v) for k, v in block_case.items()}
    got = fn(c["dz"], c["feat"], c["g"], c["w1"])
    for name, a, b in zip(("d_feat", "dW1", "db1"), got, _manual_bwd_a(block_case)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=2e-5, err_msg=name)


def test_bwd_b_rounds_the_frame_sum_to_the_activation_dtype(block_case):
    """In bfloat16 d_base and dW2b see sum_t dz2 rounded once to bf16, as
    `_chain_manual_bwd` has it (`dz2_sum ... .astype(ct)`)."""
    c = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in block_case.items()}
    d_i1, d_base, _, dw2b, _ = pfrb_bwd_b_ref(c["dz"], c["i1"], c["base"], c["w2f"], c["w2b"])
    assert d_i1.dtype == d_base.dtype == torch.bfloat16 and dw2b.dtype == torch.float32
    dzsum = c["dz"].float().sum(1).to(torch.bfloat16).float()
    want = torch.nn.grad.conv2d_weight(c["base"].float().permute(0, 3, 1, 2), (C, C, 3, 3),
                                       dzsum.permute(0, 3, 1, 2), padding=1).permute(2, 3, 1, 0)
    torch.testing.assert_close(dw2b, want, atol=1e-5, rtol=1e-5)


def _tf32(x):
    """float32 -> TF32 by cvt.rna's rule, as the float32 kernels round:
    add 0x1000 to the bits, then clear the low 13."""
    bits = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _tensor_core_gemm(a, b, split):
    """a [M,K] @ b [K,N] with the operand arithmetic of kernels 5-6's float32
    entries: k-steps of 8, each TF32 product of a step exact (float64) and
    added to a float32 accumulator.  split: x = hi + lo, both TF32, and the
    products lo*hi, hi*lo, hi*hi in that order (3xTF32); else one TF32
    product hi*hi."""
    a_hi, b_hi = _tf32(a), _tf32(b)
    a_lo, b_lo = _tf32(a - a_hi), _tf32(b - b_hi)
    pairs = [(a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi)] if split else [(a_hi, b_hi)]
    acc = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for k in range(0, a.shape[1], 8):
        for x, y in pairs:
            prod = x[:, k:k + 8].astype(np.float64) @ y[k:k + 8].astype(np.float64)
            acc = (acc + prod).astype(np.float32)
    return acc


@pytest.mark.parametrize("m,k", [(128, 576), (576, 16384)],
                         ids=["data_gradient", "weight_gradient"])
def test_3xtf32_split_holds_the_float32_check(m, k):
    """The GEMMs of kernels 5-6 (a data gradient: 128 pixels x 9 taps x 64
    channels; a weight gradient: 576 (tap, channel) x 16,384 pixels), 64
    output channels: the 3xTF32 split stays within 1e-5 of max|float64|,
    while one TF32 product lands above the 1e-4 kernel check, which is why
    the kernels split."""
    rng = np.random.default_rng(8)
    a = rng.standard_normal((m, k)).astype(np.float32)
    b = (rng.standard_normal((k, 64)) * 0.05).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    scale = np.abs(want).max()
    three = np.abs(_tensor_core_gemm(a, b, split=True) - want).max() / scale
    one = np.abs(_tensor_core_gemm(a, b, split=False) - want).max() / scale
    assert three <= 1e-5, three
    assert one > 1e-4, one


def _gradcheck_inputs(rng, shapes, scale=0.3):
    return [torch.from_numpy(rng.standard_normal(s) * scale).requires_grad_() for s in shapes]


def test_gradcheck_pfrb_chain():
    """float64, 2 blocks of 4 channels (the plain versions take any width)."""
    rng = np.random.default_rng(2)
    c, t = 4, 2
    shapes = [(3, 3, c, c), (c,), (t, c, c), (c,), (3, 3, c, c), (3, 3, c, c), (c,)]
    feat, *params = _gradcheck_inputs(rng, [(1, t, 3, 4, c)] + shapes * 2)
    assert torch.autograd.gradcheck(lambda f, *p: PFRBChain.apply(f, *p), (feat, *params))


def test_gradcheck_merge_tail():
    """float64 tail at 4 channels, 2 frames, 12 merge channels (Wm2 3->3)."""
    rng = np.random.default_rng(3)
    t, c = 2, 4
    args = _gradcheck_inputs(rng, [(1, t, 3, 4, c), (3, 3, t * c, 12), (12,), (3, 3, 3, 3), (3,)])
    assert torch.autograd.gradcheck(MergeTail.apply, args)
