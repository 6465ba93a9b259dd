"""A cell cut to a size the CPU runs in seconds, for the benchmark's tests:
the configuration's widths kept, PFNL at 2 blocks, small frames, few clips."""

import time

import torch

from benchmark import core

TINY_SEED = 2 ** 31 + 12345   # beyond 32 signed bits, as the driver's seeds are


def spec(cell, root=core.ROOT):
    s = core.cell(cell, root)
    cfg, tr = s["config"], s["traffic"]
    if cfg["model"] == "pfnl":
        cfg["num_blocks"] = cfg["port_kwargs"]["num_blocks"] = 2
    if tr["driver"] == "clips":
        tr.update(lr_hw=[16, 24], clip_frames=[8, 10], scenes=2, check_clips=2)
    else:
        tr.update(sequences=2, sequence_frames=8, gt_hw=[64, 64], warm_steps=1)
        cfg["train"].update(batch_size=2, in_size=8)
    return s


def context(s, seed=TINY_SEED, seconds=2.0, device="cpu"):
    return core.Context(s, seed, seconds, False, torch.device(device), time.perf_counter())


def run(cell, seed=TINY_SEED, seconds=2.0):
    s = spec(cell)
    rec = core.driver(s["traffic"]).run(context(s, seed, seconds))
    return s, rec
