"""Dataclass configs with the reference's hard-coded hyperparameters as
canned presets — a copy of pfnl_tpu/config.py, so that the port and
chip_smoke.py load nothing of the JAX package (tests/test_torch_train.py
holds every preset equal to the original).

The reference has no config system — every value is a `self.*` attribute in
each model's __init__.  Here the same values are data, selectable as
`preset("pfnl")` etc., and overridable from the CLI.
"""

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass
class Config:
    model: str = "pfnl"
    num_frames: int = 7
    scale: int = 4
    in_size: int = 32
    eval_in_size: Tuple[int, int] = (128, 240)
    batch_size: int = 16
    eval_batch_size: int = 4
    learning_rate: float = 1e-3
    end_lr: float = 1e-4
    decay_power: float = 1.0
    max_step: int = int(1.5e5 + 1)
    decay_step: float = 1.2e5
    reload: bool = True
    # staged optimization: SR-only until this step, then joint
    # (model/vespcn.py:253-257, model/drvsr.py:372-376); None = single stage
    stage_switch_step: Optional[int] = None
    # producer: "single" (GT-only, on-device degradation),
    # "double" (pre-rendered LR + center GT), "frvsr" (LR + all GT)
    producer: str = "single"
    # data/checkpoint/log locations
    train_list: str = "./data/filelist_train.txt"
    eval_list: str = "./data/filelist_val.txt"
    save_dir: str = "./checkpoint/pfnl"
    log_path: str = "./pfnl.txt"
    # perf knobs (no reference counterpart)
    compute_dtype: str = "float32"  # "bfloat16" for throughput runs
    host_threads: int = 2
    prefetch: int = 4
    seed: int = 0

    @property
    def gt_size(self) -> int:
        return self.in_size * self.scale


def preset(name: str, **overrides) -> Config:
    cfgs = {
        # model/pfnl.py:21-37
        "pfnl": dict(
            model="pfnl", num_frames=7, in_size=32, batch_size=16,
            producer="single", save_dir="./checkpoint/pfnl", log_path="./pfnl.txt",
        ),
        # model/vespcn.py:31-48
        "vespcn": dict(
            model="vespcn", num_frames=3, in_size=32, batch_size=16,
            stage_switch_step=10000, producer="double",
            save_dir="./checkpoint/vespcn", log_path="./vespcn.txt",
        ),
        # model/ltdvsr.py:32-49 (in_size 30 quirk)
        "ltdvsr": dict(
            model="ltdvsr", num_frames=5, in_size=30, batch_size=16,
            stage_switch_step=10000, producer="double",
            save_dir="./checkpoint/ltdvsr", log_path="./ltdvsr.txt",
        ),
        # model/mcresnet.py:31-49
        "mcresnet": dict(
            model="mcresnet", num_frames=5, in_size=32, batch_size=16,
            stage_switch_step=10000, producer="double",
            save_dir="./checkpoint/mcresnet", log_path="./mcresnet.txt",
        ),
        # model/drvsr.py:26-48 (crop 100, batch 10, decay power 0.9)
        "drvsr": dict(
            model="drvsr", num_frames=3, in_size=100, batch_size=10,
            stage_switch_step=10000, decay_power=0.9, producer="double",
            save_dir="./checkpoint/drvsr", log_path="./drvsr.txt",
        ),
        # model/frvsr.py:22-38 (lr 1e-4 flat, 4e5 steps, 10-frame recurrent)
        "frvsr": dict(
            model="frvsr", num_frames=10, in_size=32, batch_size=16,
            learning_rate=1e-4, end_lr=1e-4, max_step=int(4e5 + 1),
            producer="frvsr",
            save_dir="./checkpoint/frvsr", log_path="./frvsr.txt",
        ),
        # model/dufvsr.py:20-36 (batch 11)
        "duf": dict(
            model="duf", num_frames=7, in_size=32, batch_size=11,
            producer="double",
            save_dir="./checkpoint/duf_52", log_path="./duf_52.txt",
        ),
    }
    if name not in cfgs:
        raise KeyError(f"unknown preset {name!r}; have {sorted(cfgs)}")
    d = cfgs[name]
    d.update(overrides)
    return Config(**d)
