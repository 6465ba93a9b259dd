"""Multi-process execution — counterpart of pfnl_tpu/parallel/multihost.py.

PyTorch's idiom is one process per device: each process is one rank of a
`torch.distributed` process group and drives its own device, `cuda:<local
rank>` (or the CPU).  Where JAX builds a process-major mesh and feeds each
process's rows with `make_array_from_process_local_data`, a rank here
renders its own rows (`local_batch_size`) and DistributedDataParallel
all-reduces the gradients (train/trainer.py).

  * `initialize()` brings the group up: NCCL on the card, gloo on the CPU,
    over a TCP rendezvous at the coordinator's address (or the environment's
    `MASTER_ADDR`/`MASTER_PORT`, `RANK`, `WORLD_SIZE` under torchrun); a
    no-op when nothing asks for more than one process;
  * `is_main()`, `rank()`, `world_size()`, `barrier()`;
  * `local_device()`: the device a rank drives;
  * `local_batch_size()`: a rank's share of the global batch;
  * `broadcast_from_main()`: rank 0's copy of a state dict on every rank
    (after a restore only rank 0 read, since only rank 0 saves).
"""

import os
from typing import Optional

import torch
import torch.distributed as dist


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device: str = "cuda",
               backend: Optional[str] = None) -> None:
    """Join the process group (once).  coordinator_address: "host:port" of
    rank 0's rendezvous; without it the environment's (torchrun's) is used.
    device: "cuda" (NCCL, and this process drives cuda:<local rank>) or
    "cpu" (gloo); backend overrides the choice.  A no-op without arguments
    and without RANK / WORLD_SIZE in the environment."""
    if dist.is_initialized():
        return
    from_env = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    if coordinator_address is None and num_processes is None and not from_env:
        return
    backend = backend or ("nccl" if torch.device(device).type == "cuda" else "gloo")
    if coordinator_address is not None:
        init_method = f"tcp://{coordinator_address}"
    else:
        init_method = "env://"
        if num_processes is None:
            num_processes = int(os.environ["WORLD_SIZE"])
        if process_id is None:
            process_id = int(os.environ["RANK"])
    if backend == "nccl":
        torch.cuda.set_device(local_device("cuda", process_id))
    dist.init_process_group(backend, init_method=init_method, world_size=num_processes,
                            rank=process_id)


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    """Every rank waits for the others (nothing on one process)."""
    if world_size() > 1:
        dist.barrier()


def local_device(device: str = "cuda", process_rank: Optional[int] = None) -> torch.device:
    """The device a rank drives: a device named with its index, or the CPU,
    as named; else cuda:<LOCAL_RANK> (torchrun's), else cuda:<rank modulo
    the visible GPUs>."""
    if torch.device(device).type != "cuda" or torch.device(device).index is not None:
        return torch.device(device)
    if "LOCAL_RANK" in os.environ:
        return torch.device("cuda", int(os.environ["LOCAL_RANK"]))
    r = rank() if process_rank is None else process_rank
    return torch.device("cuda", r % torch.cuda.device_count())


def local_batch_size(global_batch_size: int, n_data: Optional[int] = None) -> int:
    """A rank's rows of the global batch, split over n_data data ranks (all
    ranks by default); raises when they do not divide it."""
    n = n_data or world_size()
    if global_batch_size % n:
        raise ValueError(f"global batch {global_batch_size} not divisible by {n} data ranks")
    return global_batch_size // n


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def broadcast_from_main(obj):
    """Rank 0's `obj` (a state dict, nested dicts and lists of tensors and
    numbers; tensors arrive on the CPU) on every rank; `obj` itself on one
    process.  Every rank must call it."""
    if world_size() == 1:
        return obj
    box = [_to_cpu(obj) if is_main() else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]
