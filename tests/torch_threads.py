"""Imported by the port's test files (tests/test_torch_*.py): under
pytest-xdist each worker process would run PyTorch's CPU kernels on every
core, so the workers' thread pools oversubscribe the machine. A worker
caps its intra-op threads at its share of the cores; a serial run keeps
PyTorch's default."""
import os

import torch

_WORKERS = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _WORKERS > 1:
    torch.set_num_threads(max(1, len(os.sched_getaffinity(0)) // _WORKERS))
