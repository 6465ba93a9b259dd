"""Data-parallel forwards over several devices from one process —
counterpart of `sharded_apply_dp` / `sharded_forward_dp` in
pfnl_tpu/parallel/spmd.py.

Serving needs no collective: each device runs the whole single-device
program, kernels included, on its rows of the batch.  So where the JAX
package `shard_map`s the per-chip program over a mesh, one process here
holds a replica of the model on each device, splits the batch evenly by
rows, issues each shard's work on its own device (the launches are
asynchronous, so the devices run together) and gathers the results in
order onto the first device.

The JAX package's other path, `sharded_forward` (GSPMD: image rows sharded
over `space`, the halos and the attention's collectives inserted by XLA),
has no counterpart in PyTorch short of DTensor's experimental convolution
sharding; it is still to port (ROADMAP.md, Queue 1).
"""

import copy

import torch


def device_list(devices):
    """torch.devices, a CUDA device with its index ("cuda" is cuda:0)."""
    out = []
    for d in devices:
        d = torch.device(d)
        out.append(torch.device("cuda", 0) if d.type == "cuda" and d.index is None else d)
    return out


def replicate(model, devices):
    """{device: a replica of model on it}; the model itself serves its own
    device, the others get copies of it (in the model's mode)."""
    own = device_list([next(model.parameters()).device])[0]
    return {d: model if d == own else copy.deepcopy(model).to(d) for d in device_list(devices)}


def sharded_apply_dp(per_device, devices):
    """call(x) running per_device(device, x_shard) -> y_shard on each of
    `devices` (torch.device) with x's rows split evenly over them, the
    results concatenated in order on devices[0].  x and y are batch-major;
    raises when the devices do not divide x's rows."""
    devices = device_list(devices)

    def call(x):
        n = len(devices)
        if x.shape[0] % n:
            raise ValueError(f"a batch of {x.shape[0]} does not split over {n} devices")
        shards = x.split(x.shape[0] // n)
        outs = [per_device(d, s.to(d, non_blocking=True)) for d, s in zip(devices, shards)]
        return torch.cat([o.to(devices[0]) for o in outs])

    return call


def sharded_forward_dp(model, devices):
    """fn(x) -> model(x) with x's rows split over `devices`, a replica of
    the model on each (the raw "sr" for a model returning a dict)."""
    replicas = replicate(model, devices)

    def per_device(device, x):
        out = replicas[device](x)
        return out["sr"] if isinstance(out, dict) else out

    return sharded_apply_dp(per_device, devices)
