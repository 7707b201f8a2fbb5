"""Devices and data parallelism: the process group of data-parallel training
(replicated or fully sharded) and the device list of a multi-device codec
or eval sweep."""
from .fsdp import FullyShardedState, shard_state
from .mesh import (DataParallel, best_mesh_size, data_parallel_eval, fsdp_plan,
                   init_distributed, make_mesh, shard_batch, shard_rows, teardown)

__all__ = ["DataParallel", "FullyShardedState", "best_mesh_size", "data_parallel_eval",
           "fsdp_plan", "init_distributed", "make_mesh", "shard_batch", "shard_rows",
           "shard_state", "teardown"]
