"""The training step, plain PyTorch, float32, the parts every family shares
(reference repository `model/base_model.py:150-199`, `model/pfnl.py:21-37,
156-199`):

    gt crops [B,T,S,S,3] uint8 -> float / 255; per sample, rows flipped,
    columns flipped, then rows and columns swapped, each with probability
    1/2; LR = the degradation (13x13 Gaussian, sigma 1.6, stride `scale`) of
    every frame; the model's loss of the SR of the LR window against the
    centre GT frame (its reference module's `train_loss`); Adam (0.9,
    0.999, 1e-8) at the polynomial learning rate of the step before its
    increment (1e-3 to 1e-4 over decay_steps, power 1).

The flips are the training semantics' random draw: the uniform values of
step k come from a CUDA `torch.Generator` seeded with ((seed + 1) << 32) + k,
three per sample, a value below 0.5 meaning "flip".  The reference draws
them itself from that rule.
"""

import torch

from benchmark.reference.ops import degrade


def learning_rate(step: int, init: float, end: float, power: float, decay_steps: int) -> float:
    frac = 1.0 - min(max(step, 0), decay_steps) / decay_steps
    return (init - end) * frac ** power + end


def flips(seed: int, step: int, batch: int, device) -> torch.Tensor:
    gen = torch.Generator(device=device).manual_seed(((seed + 1) << 32) + step)
    return torch.rand((batch, 3), generator=gen, device=device) < 0.5


def augment(gt, f):
    """gt [B,T,S,S,C]; f [B,3] bool: rows, columns, transpose."""
    out = []
    for x, (rows, cols, swap) in zip(gt, f.tolist()):
        if rows:
            x = x.flip(1)
        if cols:
            x = x.flip(2)
        if swap:
            x = x.transpose(1, 2)
        out.append(x)
    return torch.stack(out)


def loss_fn(model, params, gt_u8, f, cfg):
    dtype = next(iter(params.values())).dtype
    gt = augment(gt_u8.to(dtype) / 255.0, f)
    lr = degrade(gt, cfg["scale"])
    return model.train_loss(params, gt, lr, cfg)


def run(model, params0, batches, seed: int, cfg, schedule):
    """The steps of `batches` (uint8 GT crops on the device, in order) from
    the weights params0 (name -> float32 tensor) of the configuration cfg,
    whose reference module `model` gives its loss.  schedule: (init lr, end
    lr, power, decay steps).  Returns (losses, first step's gradients,
    weights after the last step)."""
    params = {k: v.detach().clone().requires_grad_(True) for k, v in params0.items()}
    m = {k: torch.zeros_like(v) for k, v in params.items()}
    v2 = {k: torch.zeros_like(v) for k, v in params.items()}
    losses, first_grads = [], None
    b1, b2, eps = 0.9, 0.999, 1e-8
    for k, gt_u8 in enumerate(batches):
        f = flips(seed, k, gt_u8.shape[0], gt_u8.device)
        loss = loss_fn(model, params, gt_u8, f, cfg)
        grads = torch.autograd.grad(loss, list(params.values()))
        losses.append(float(loss.detach()))
        if first_grads is None:
            first_grads = {name: g.detach().clone() for name, g in zip(params, grads)}
        lr = learning_rate(k, *schedule)
        t = k + 1
        with torch.no_grad():
            for (name, p), g in zip(params.items(), grads):
                m[name].mul_(b1).add_(g, alpha=1 - b1)
                v2[name].mul_(b2).addcmul_(g, g, value=1 - b2)
                mhat = m[name] / (1 - b1 ** t)
                vhat = v2[name] / (1 - b2 ** t)
                p.sub_(lr * mhat / (vhat.sqrt() + eps))
    return losses, first_grads, {k: v.detach() for k, v in params.items()}
