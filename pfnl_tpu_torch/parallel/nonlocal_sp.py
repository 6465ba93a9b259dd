"""Spatially sharded non-local attention — counterpart of
pfnl_tpu/parallel/nonlocal_sp.py (context parallelism over HW).

At large test resolutions the non-local block's queries can be split over
the ranks of a group (the mesh's `space` axis): each rank holds one query
block [B, N/size, D] and the block of keys and values at the same
positions; the whole key and value set is gathered from every rank
(`all_gather`: keys and values are small, N x 84 channels, so gathering
them is the layout; a ring schedule would only pay if they outgrew a
device).  Each rank then runs the attention of its queries: kernel 1
(`ops/cuda/nonlocal_flash.nonlocal_flash`) on the card, and on the CPU the
JAX package's rule, the chunked form above 4096 keys and the dense one
otherwise (or as `impl` says).
"""

import torch
import torch.distributed as dist

from pfnl_tpu_torch.ops.cuda.nonlocal_flash import nonlocal_flash
from pfnl_tpu_torch.ops.nonlocal_attn import nonlocal_attention, nonlocal_attention_chunked

DENSE_MAX_KEYS = 4096   # the CPU's "auto": chunked above this many keys


def local_block(x: torch.Tensor, group=None) -> torch.Tensor:
    """This rank's block of a whole sequence x [B, N, D] along N; raises
    when the group's size does not divide N."""
    size, r = dist.get_world_size(group), dist.get_rank(group)
    n = x.shape[1]
    if n % size:
        raise ValueError(f"N={n} not divisible by the group's {size} ranks")
    return x[:, r * (n // size):(r + 1) * (n // size)].contiguous()


def _gather(x: torch.Tensor, group) -> torch.Tensor:
    """[B, n, D] blocks of every rank, concatenated along n in rank order."""
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts, 1)


def nonlocal_attention_sp(theta: torch.Tensor, phi: torch.Tensor, g: torch.Tensor, group=None,
                          impl: str = "auto") -> torch.Tensor:
    """softmax(theta phi^T) g with this rank's query block theta [B, n, D]
    against the keys phi and values g of every rank's block (each [B, n, *],
    n the same on every rank) -> this rank's output block [B, n, Dv].
    impl (the CPU only): "auto", "dense" or "chunked"."""
    if impl not in ("auto", "dense", "chunked"):
        raise ValueError(f"impl must be auto, dense or chunked, got {impl!r}")
    phi_all, g_all = _gather(phi, group), _gather(g, group)
    if theta.device.type != "cpu":
        return nonlocal_flash(theta, phi_all, g_all)
    if impl == "chunked" or (impl == "auto" and phi_all.shape[1] > DENSE_MAX_KEYS):
        return nonlocal_attention_chunked(theta, phi_all, g_all)
    return nonlocal_attention(theta, phi_all, g_all)
