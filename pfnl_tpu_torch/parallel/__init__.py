"""Multi-GPU execution — counterpart of pfnl_tpu/parallel/: process groups
(multihost.py), the (data, space) device mesh (mesh.py), data-parallel
serving from one process (spmd.py) and spatially sharded non-local
attention (nonlocal_sp.py).  Training runs one process per device under
DistributedDataParallel (train/trainer.py)."""
