"""The weight bridge between flax params trees and the port's state_dicts.

The port's modules keep flax's parameter names and layouts: a conv
`kernel` is HWIO ([kh,kw,Cin,Cout]), PFNL's fusion kernel
`conv10_{i}_kernel` is [T,C,C], biases are [C].  So the bridge only turns
tree paths into state_dict keys (`nlblock_0/g/kernel` ->
`nlblock_0.g.kernel`, `conv1_3_kernel` stays) and arrays into float32
tensors; no array is transposed.
"""

import numpy as np
import torch


def from_flax(params) -> dict:
    """Nested dict of arrays (a flax `params` tree, the value of
    variables["params"]) -> state_dict of float32 CPU tensors."""
    out = {}

    def walk(node, prefix):
        for k, v in node.items():
            name = f"{prefix}.{k}" if prefix else str(k)
            if hasattr(v, "items"):  # dict or flax FrozenDict
                walk(v, name)
            else:
                out[name] = torch.from_numpy(np.asarray(v, np.float32).copy())

    walk(params, "")
    return out


def load_npz(path: str) -> dict:
    """Read a flat `.npz` whose keys are '/'-joined flax paths into a
    state_dict."""
    with np.load(path) as z:
        return {k.replace("/", "."): torch.from_numpy(z[k].astype(np.float32)) for k in z.files}
