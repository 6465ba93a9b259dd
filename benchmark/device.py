"""The card a run used, for its result line.

`card_label` is frozen from pfnl_tpu_torch/utils/device.py:10-27
(`device_label`): the card's name and power limit as nvidia-smi gives
them, its name alone where nvidia-smi does not answer.
"""

import subprocess

import torch


def card_label(index: int = 0) -> str:
    try:
        lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True, timeout=60).stdout.strip().splitlines()
        return lines[index].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(index)
