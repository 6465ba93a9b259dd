"""What ran the work, and the float32 precision it ran at: helpers shared by
the port's benches and records."""

import contextlib
import subprocess

import torch


def device_label(device) -> str:
    """The card's name and power limit as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` gives them for a
    CUDA device (its name alone where nvidia-smi does not answer), "CPU"
    for the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return "CPU"
    index = device.index if device.index is not None else torch.cuda.current_device()
    try:
        lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True, timeout=60).stdout.strip().splitlines()
        return lines[index].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(index)


@contextlib.contextmanager
def tf32_off():
    """float32 matmuls and cuDNN convolutions in full float32 inside, the
    previous settings restored after."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
