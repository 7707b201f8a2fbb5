"""``cudnn_ms.train``: Device ms per step of the convolution and matmul library
kernels (cuDNN, cuBLAS; trace.LIBRARY)."""
from __future__ import annotations

from portbench import trace



def read(rec):
    return rec.group_ms_per_unit(trace.LIBRARY_GROUP)
