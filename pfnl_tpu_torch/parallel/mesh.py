"""The (data, space) device mesh — counterpart of pfnl_tpu/parallel/mesh.py.

  data   data-parallel training and serving (DistributedDataParallel
         all-reduces the gradients over it; a training BatchNorm takes its
         statistics over it)
  space  spatial parallelism of the non-local attention
         (parallel/nonlocal_sp.py); training replicates its step over it,
         as the JAX package shards the batch over `data` alone

One rank per device, so the mesh spans every rank of the process group
(`torch.distributed.device_mesh.init_device_mesh`, which brings the group
up from the environment when no one has).
"""

from typing import Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

AXES = ("data", "space")


def make_mesh(n_data: Optional[int] = None, n_space: int = 1) -> DeviceMesh:
    """A mesh of n_data x n_space ranks (n_data: the world over n_space by
    default), of CUDA devices over an NCCL group, else of the CPU."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if n_data is None:
        n_data = world // n_space
    if n_data * n_space != world:
        raise ValueError(f"a {n_data}x{n_space} mesh needs {n_data * n_space} ranks, "
                         f"the process group has {world}")
    device_type = "cuda" if dist.is_initialized() and dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_space), mesh_dim_names=AXES)


def data_group(mesh: DeviceMesh):
    """The process group of this rank's data axis."""
    return mesh.get_group("data")


def space_group(mesh: DeviceMesh):
    """The process group of this rank's space axis."""
    return mesh.get_group("space")
