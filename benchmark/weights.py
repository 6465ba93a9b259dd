"""Seeded weights for a configuration, made on the device.

The program's model is built by its constructor (its own host-side init,
0.04-0.12 s, is overwritten: built on the meta device instead, the model
took 6-9 s on the card's host, torch's distributed and symbolic modules
loading) and moved to the device; its parameters and buffers are then
drawn by the benchmark: one uniform draw from a `torch.Generator` on the
device covers every leaf, each leaf's slice scaled by the first rule of
the configuration's `init` that its name matches.  The same tensors go into the program (copied by
`load_state_dict`) and, unchanged, to the reference.

Rules: "glorot" U(-l, l) with l = sqrt(6 / (fan_in + fan_out)), "he"
l = sqrt(6 / fan_in), fan_in the product of all axes but the last and
fan_out of all but the second to last, either optionally times a factor
("glorot*0.1"); "range:lo:hi" U(lo, hi).
"""

import math
import re

import torch


def _limit(rule: str, shape) -> float:
    kind, _, factor = rule.partition("*")
    numel = math.prod(shape)
    fan_in = numel // shape[-1]
    fan_out = numel // shape[-2] if len(shape) > 1 else shape[-1]
    if kind == "glorot":
        lim = math.sqrt(6.0 / (fan_in + fan_out))
    elif kind == "he":
        lim = math.sqrt(6.0 / fan_in)
    else:
        raise ValueError(f"unknown init rule {rule!r}")
    return lim * (float(factor) if factor else 1.0)


def draw(shapes: dict, rules, seed: int, device) -> dict:
    """{name: shape} -> {name: float32 tensor on device}; rules: [[regex, rule], ...]."""
    total = sum(math.prod(s) for s in shapes.values())
    gen = torch.Generator(device=device).manual_seed(seed)
    u = torch.rand(total, generator=gen, device=device)
    out, at = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape)
        part = u[at:at + n].reshape(shape)
        at += n
        rule = next((r for pat, r in rules if re.search(pat, name)), None)
        if rule is None:
            raise KeyError(f"no init rule matches {name}")
        if rule.startswith("range:"):
            lo, hi = (float(v) for v in rule.split(":")[1:])
            out[name] = part * (hi - lo) + lo
        else:
            out[name] = (part * 2.0 - 1.0) * _limit(rule, shape)
    return out


def build(config: dict, dtype: torch.dtype, device, seed: int):
    """(the program's model of `config` holding seeded weights, on device;
    the weights as a dict for the reference)."""
    from pfnl_tpu_torch.models import MODEL_REGISTRY

    model = MODEL_REGISTRY[config["model"]](dtype=dtype, **config["port_kwargs"]).to(device)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    weights = draw(shapes, config["init"], seed, device)
    model.load_state_dict(weights)
    return model, weights
