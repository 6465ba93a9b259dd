"""Non-local softmax attention, the plain PyTorch versions of kernel 1
(counterpart: pfnl_tpu/ops/nonlocal_attn.py).

    y = softmax(theta @ phi^T) @ g          per batch element, NO 1/sqrt(d)

Inputs are [B,N,D], [B,M,D] and [B,M,Dv] in any float dtype; scores and
the softmax are float32 and the result comes back in g's dtype.
"""

import torch


def nonlocal_attention(theta, phi, g):
    """Dense quadratic attention: materialises the [B,N,M] scores (the
    row max is subtracted before exp, which changes nothing but overflow)."""
    f = torch.einsum("bnd,bmd->bnm", theta.float(), phi.float())
    f = torch.exp(f - f.amax(dim=-1, keepdim=True))
    f = f / f.sum(dim=-1, keepdim=True)
    return torch.einsum("bnm,bmd->bnd", f.to(g.dtype), g)


def nonlocal_attention_chunked(theta, phi, g, block: int = 1024):
    """Streaming softmax over key blocks with a running (max, denominator,
    accumulator) — the recurrence kernel 1 runs; peak memory [B,N,block]."""
    b, n, _ = theta.shape
    m = phi.shape[1]
    dv = g.shape[-1]
    th = theta.float()
    acc = th.new_zeros(b, n, dv)
    denom = th.new_zeros(b, n)
    mx = th.new_full((b, n), float("-inf"))
    for k0 in range(0, m, block):
        s = torch.einsum("bnd,bkd->bnk", th, phi[:, k0:k0 + block].float())
        new_mx = torch.maximum(mx, s.amax(dim=-1))
        scale = torch.exp(mx - new_mx)
        p = torch.exp(s - new_mx[..., None])
        acc = acc * scale[..., None] + torch.einsum(
            "bnk,bkv->bnv", p, g[:, k0:k0 + block].float())
        denom = denom * scale + p.sum(dim=-1)
        mx = new_mx
    return (acc / denom[..., None]).to(g.dtype)
