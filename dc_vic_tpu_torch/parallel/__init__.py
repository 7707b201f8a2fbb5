"""Devices and data parallelism: the process group of data-parallel training
and the device list of a multi-device codec."""
from .mesh import (DataParallel, best_mesh_size, init_distributed, make_mesh, shard_batch,
                   shard_rows, teardown)

__all__ = ["DataParallel", "best_mesh_size", "init_distributed", "make_mesh", "shard_batch",
           "shard_rows", "teardown"]
