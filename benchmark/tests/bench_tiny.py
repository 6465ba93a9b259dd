"""A cell cut to a size the CPU runs in seconds, for the benchmark's tests:
the configuration's widths kept, its `cpu_cut` applied (a key only these
tests read), small frames, few clips."""

import time

import torch

from benchmark import core

TINY_SEED = 2 ** 31 + 12345   # beyond 32 signed bits, as the driver's seeds are


def cut(s):
    """The cell's spec `s` cut to the CPU size, in place: the configuration's
    `cpu_cut` on its keys and on the program's `port_kwargs`, the traffic at
    small frames and few clips or steps."""
    cfg, tr = s["config"], s["traffic"]
    for k, v in cfg.get("cpu_cut", {}).items():
        cfg[k] = v
        if k in cfg["port_kwargs"]:
            cfg["port_kwargs"][k] = v
    if tr["driver"] == "clips":
        tr.update(lr_hw=[16, 24], clip_frames=[8, 10], scenes=2, check_clips=2)
    else:
        tr.update(sequences=2, sequence_frames=8, gt_hw=[64, 64], warm_steps=1)
        cfg["train"].update(batch_size=2, in_size=8)
        if "train" in tr:
            tr["train"].update(batch_size=2, in_size=8)
    return s


def spec(cell, root=core.ROOT):
    return cut(core.cell(cell, root))


def _cells(root):
    """[(cell, its configuration, its traffic's driver)] in the manifest's order."""
    out = []
    for w in core.manifest(root)["workloads"]:
        s = core.cell(w["name"], root)
        out.append((w["name"], w["config"], s["traffic"]["driver"]))
    return out


def one_per_pair(root=core.ROOT):
    """The first cell of each (configuration, driver) pair, in the manifest's order."""
    first = {}
    for name, config, drv in _cells(root):
        first.setdefault((config, drv), name)
    return list(first.values())


def serving_cells(root=core.ROOT):
    """The first `clips` cell of each configuration."""
    firsts = one_per_pair(root)
    return [name for name, _, drv in _cells(root) if drv == "clips" and name in firsts]


def training_cells(root=core.ROOT):
    """Every `fit` cell."""
    return [name for name, _, drv in _cells(root) if drv == "fit"]


def every_cell(root=core.ROOT):
    """Every cell, grouped by driver in the order the drivers first appear in
    the manifest, each group in the manifest's order."""
    cells = _cells(root)
    order = list(dict.fromkeys(drv for _, _, drv in cells))
    return [name for d in order for name, _, drv in cells if drv == d]


def context(s, seed=TINY_SEED, seconds=2.0, device="cpu"):
    return core.Context(s, seed, seconds, False, torch.device(device), time.perf_counter())


def run(cell, seed=TINY_SEED, seconds=2.0):
    s = spec(cell)
    rec = core.driver(s["traffic"]).run(context(s, seed, seconds))
    return s, rec
