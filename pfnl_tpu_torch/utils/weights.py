"""The weight bridge between flax variables and the port's state_dicts.

The port's modules keep flax's parameter names and layouts: a conv
`kernel` is HWIO ([kh,kw,Cin,Cout]), DUF's `W` DHWIO, PFNL's fusion kernel
`conv10_{i}_kernel` is [T,C,C], biases are [C]; DUF's BatchNorm state
(`batch_stats`: `moving_mean`, `moving_variance`, `biased_mean`,
`biased_var`, `local_step`) are buffers under the same names.  So the
bridge only turns tree paths into state_dict keys (`nlblock_0/g/kernel` ->
`nlblock_0.g.kernel`, `G/Rbn1a/moving_mean` -> `G.Rbn1a.moving_mean`) and
arrays into float32 tensors; no array is transposed.
"""

import numpy as np
import torch

COLLECTIONS = ("params", "batch_stats")


def from_flax(params, batch_stats=None) -> dict:
    """Nested dicts of arrays (the values of variables["params"] and, for a
    model with BatchNorm state, variables["batch_stats"]) -> one state_dict
    of float32 CPU tensors (a scalar such as `local_step` has shape ())."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            name = f"{prefix}.{k}" if prefix else str(k)
            if hasattr(v, "items"):  # dict or flax FrozenDict
                walk(v, name)
            else:
                out[name] = torch.from_numpy(np.array(v, np.float32))

    walk(params, "")
    if batch_stats is not None:
        walk(batch_stats, "")
    return out


def to_flax(model) -> tuple:
    """The inverse of `from_flax` for a model's current weights: (params,
    batch_stats), nested dicts of float32 numpy arrays keyed as flax keys
    them (the model's buffers are its BatchNorm state; batch_stats is empty
    for a model without)."""
    def nest(named):
        tree = {}
        for name, t in named:
            *path, leaf = name.split(".")
            node = tree
            for k in path:
                node = node.setdefault(k, {})
            node[leaf] = t.detach().cpu().float().numpy()
        return tree

    return nest(model.named_parameters()), nest(model.named_buffers())


def load_npz(path: str) -> dict:
    """Read a flat `.npz` whose keys are '/'-joined flax paths into a
    state_dict.  The keys of a checkpoint that carries both collections
    begin with the collection's name (`params/G/conv1/W`,
    `batch_stats/G/Rbn1a/local_step`, as in flax's variables dict); that
    name is dropped."""
    out = {}
    with np.load(path) as z:
        for k in z.files:
            head, _, rest = k.partition("/")
            name = rest if head in COLLECTIONS and rest else k
            out[name.replace("/", ".")] = torch.from_numpy(z[k].astype(np.float32))
    return out
