"""Plain PyTorch versions of DUF's dense-block kernels: kernel 9 (one dense
block on the persistent buffer, `dense_block_ref`, and the backbone loop
around it, `dense_backbone_ref`) and kernel 10 (the 3x3x3 growth conv,
`conv3x3x3_ref`).  Counterparts: `_run_block` / `dense_backbone_fused` in
pfnl_tpu/ops/pallas/duf_block.py and `_conv3x3x3_xla` in
pfnl_tpu/ops/pallas/duf_dense.py.

One dense block with F input and G growth channels, BatchNorms folded
(inference), for the input planes t in [in_lo, in_hi):

    a[t] = relu(sb * (relu(sa * buf[t, ..., :F] + oa) @ Wa) + ob)
    buf[t', ..., F:F+G] = bb + conv3x3x3(a, Wb)      for the output planes t'

`a` is zero outside the image and outside [in_lo, in_hi): the reference
pads AFTER the activation.  A SAME-T block ("thw") writes every input
plane; a VALID-T block ("hw") writes [in_lo+1, in_hi-1), and the window
narrows.  Rounding is kernel 9's: `relu(sa*x+oa)` and `a` are rounded to
the activation dtype, every product is summed in float32, and the new
channels are rounded once when written.
"""

from typing import NamedTuple

import torch
import torch.nn.functional as F


class BlockParams(NamedTuple):
    sa: torch.Tensor   # [F]  BN-a folded scale
    oa: torch.Tensor   # [F]  BN-a folded offset
    wa: torch.Tensor   # [F, F] 1x1x1 conv
    sb: torch.Tensor   # [F]  BN-b folded scale
    ob: torch.Tensor   # [F]  BN-b folded offset, the 1x1x1 conv's bias folded in
    wb: torch.Tensor   # [3, 3, 3, F, G] growth conv (DHWIO)
    bb: torch.Tensor   # [G]
    mode: str          # "thw" (SAME-T) | "hw" (VALID-T)


def block_out_planes(mode: str, in_lo: int, in_hi: int):
    """The planes [out_lo, out_hi) a block with input planes [in_lo, in_hi) writes."""
    if mode == "thw":
        return in_lo, in_hi
    if mode == "hw":
        return in_lo + 1, in_hi - 1
    raise ValueError(f"block mode must be 'thw' or 'hw', got {mode!r}")


def conv3x3x3_ref(x: torch.Tensor, wk: torch.Tensor, pad_t: bool) -> torch.Tensor:
    """x [B,T,H,W,F], wk [3,3,3,F,G] (DHWIO) -> [B,T_out,H,W,G]: SAME in H/W,
    SAME (pad_t) or VALID in T, no bias, in x's dtype."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), wk.to(x.dtype).permute(4, 3, 0, 1, 2),
                 padding=(1 if pad_t else 0, 1, 1))
    return y.permute(0, 2, 3, 4, 1)


def dense_block_ref(buf: torch.Tensor, p: BlockParams, in_lo: int, in_hi: int) -> torch.Tensor:
    """One block on buf [B,T,H,W,C], in place: reads buf[:, in_lo:in_hi, ..., :F]
    and writes the G new channels [F, F+G) of the output planes.  Returns buf."""
    dt = buf.dtype
    f, g = p.wa.shape[0], p.wb.shape[-1]
    x = buf[:, in_lo:in_hi, :, :, :f].float()
    t0 = torch.relu(x * p.sa.float() + p.oa.float()).to(dt).float()
    z = t0 @ p.wa.to(dt).float()
    a = torch.relu(z * p.sb.float() + p.ob.float()).to(dt).float()
    y = conv3x3x3_ref(a, p.wb.to(dt).float(), p.mode == "thw") + p.bb.float()
    out_lo, out_hi = block_out_planes(p.mode, in_lo, in_hi)
    buf[:, out_lo:out_hi, :, :, f:f + g] = y.to(dt)
    return buf


def backbone_loop(x64: torch.Tensor, blocks, run_block) -> torch.Tensor:
    """The dense blocks over one buffer [B,T,H,W,C_fin] holding conv1's
    output x64 [B,T,H,W,C0] in its first C0 channels; `run_block(buf, p,
    in_lo, in_hi)` runs one block in place.  Returns the final features
    [B,T_fin,H,W,C_fin] (T_fin = T - 2 * #VALID-T blocks), a view of the
    buffer.  No channel is read before a block has written it."""
    nb, t, h, w, c0 = x64.shape
    cfin = c0 + sum(p.wb.shape[-1] for p in blocks)
    buf = x64.new_empty(nb, t, h, w, cfin)
    buf[..., :c0] = x64
    lo, hi = 0, t
    for p in blocks:
        run_block(buf, p, lo, hi)
        lo, hi = block_out_planes(p.mode, lo, hi)
    return buf[:, lo:hi]


def dense_backbone_ref(x64: torch.Tensor, blocks) -> torch.Tensor:
    """Every block through `dense_block_ref` (JAX: dense_backbone_fused)."""
    return backbone_loop(x64, blocks, dense_block_ref)
