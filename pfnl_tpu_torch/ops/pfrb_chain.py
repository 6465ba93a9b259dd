"""The PFRB chain under autograd: kernels 2 and 3 forward, kernels 5 and 6
backward.  Counterpart of `pfrb_chain_pack` in
pfnl_tpu/ops/pallas/pfrb_pack.py (custom VJP: `_fwd` saves each block's
feat, i1 and base; `chain_bwd_pallas` in pfrb_bwd.py runs the backward
from them, with no forward recompute).

Backward of one block, from the cotangent d_out of its output
(pfrb_bwd.py:279-315; the lrelu slope is recovered from the sign of the
activation it produced, pfrb_pack.py:452-459):

    dz2    = d_out * lrelu'(out - feat)
    d_i1, d_base, dW2f, dW2b, db2 = kernel 5 (dz2, i1, base)
    dzb    = d_base * lrelu'(base)
    d_i1  += dzb @ Wfuse_t^T;  dWfuse_t = i1_t^T dzb (float32);  dbfuse
    dz1    = d_i1 * lrelu'(i1)
    d_feat, dW1, db1 = kernel 6 (dz1, feat, d_out)

The fusion products stay in PyTorch, as they stay in XLA in JAX.  On CPU
tensors the kernel wrappers take their plain versions, so the same code
runs, and is tested, on the CPU.
"""

import torch

from pfnl_tpu_torch.ops.cuda.pfrb import pfrb_a, pfrb_b, pfrb_block
from pfnl_tpu_torch.ops.cuda.pfrb_bwd import pfrb_bwd_a, pfrb_bwd_b
from pfnl_tpu_torch.ops.pfrb_ref import acc_dtype

ALPHA = 0.2
N_PARAMS = 7  # W1, b1, Wfuse, bfuse, W2f, W2b, b2 per block


def _lrelu_grad(y):
    """lrelu'(z) from y = lrelu(z) (valid since alpha > 0), in y's dtype."""
    return torch.where(y > 0, torch.ones((), dtype=y.dtype, device=y.device),
                       torch.full((), ALPHA, dtype=y.dtype, device=y.device))


class PFRBChain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, feat, *flat_params):
        params = [flat_params[i:i + N_PARAMS] for i in range(0, len(flat_params), N_PARAMS)]
        feats, i1s, bases = [feat], [], []
        x = feat
        for w1, b1, wfuse, bfuse, w2f, w2b, b2 in params:
            i1, base = pfrb_a(x, w1, b1, wfuse, bfuse)
            x = pfrb_b(x, i1, base, w2f, w2b, b2)
            feats.append(x)
            i1s.append(i1)
            bases.append(base)
        ctx.n_blocks = len(params)
        ctx.save_for_backward(*feats, *i1s, *bases, *flat_params)
        return x

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, g):
        nb = ctx.n_blocks
        saved = ctx.saved_tensors
        feats, i1s, bases = saved[:nb + 1], saved[nb + 1:2 * nb + 1], saved[2 * nb + 1:3 * nb + 1]
        flat_params = saved[3 * nb + 1:]
        ct = feats[0].dtype
        d_out = g.to(ct).contiguous()
        grads = [None] * len(flat_params)
        for k in reversed(range(nb)):
            p = flat_params[k * N_PARAMS:(k + 1) * N_PARAMS]
            w1, _, wfuse, _, w2f, w2b, _ = p
            feat, out, i1, base = feats[k], feats[k + 1], i1s[k], bases[k]
            dz2 = d_out * _lrelu_grad(out - feat)
            d_i1, d_base, dw2f, dw2b, db2 = pfrb_bwd_b(dz2, i1, base, w2f, w2b)
            dzb = d_base * _lrelu_grad(base)
            d_i1 = d_i1 + torch.einsum("nhwd,tcd->nthwc", dzb, wfuse.to(ct))
            dwfuse = torch.einsum("nthwc,nhwd->tcd", acc_dtype(i1), acc_dtype(dzb))
            dbfuse = acc_dtype(dzb).sum((0, 1, 2))
            dz1 = (d_i1 * _lrelu_grad(i1)).contiguous()
            d_feat, dw1, db1 = pfrb_bwd_a(dz1, feat, d_out, w1)
            for j, d in enumerate((dw1, db1, dwfuse, dbfuse, dw2f, dw2b, db2)):
                grads[k * N_PARAMS + j] = d.to(p[j].dtype)
            d_out = d_feat
        return (d_out.to(g.dtype), *grads)


def pfrb_chain(feat, params_list):
    """feat [N,T,H,W,64] through the PFRBs of `params_list` (tuples of
    W1, b1, Wfuse, bfuse, W2f, W2b, b2).  Through PFRBChain when a gradient
    is wanted; otherwise block by block, keeping nothing for a backward."""
    flat = [p for block in params_list for p in block]
    if torch.is_grad_enabled() and any(x.requires_grad for x in [feat, *flat]):
        return PFRBChain.apply(feat, *flat)
    for block in params_list:
        feat = pfrb_block(feat, *block)
    return feat
