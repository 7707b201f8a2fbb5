"""Issue rates of the tensor-core instructions on the GPU at hand.

    python -m dc_vic_tpu_torch.tools.mma_rates

Builds ``mma_rates.cu`` (beside this file) with nvcc for sm_90a into the
port's build directory and runs it: ``mma.sync.m16n8k8`` from 4, 8 and 16 warps
an SM and its latency, ``wgmma.mma_async.m64n64k8`` (A from registers, B
from shared memory) from 1, 2 and 4 warpgroups an SM, ``m64n32k8`` the same
with twelve products per commit and wait (the attention kernel's score
chunk), then bf16
``wgmma.mma_async.m64n64k16`` and ``m64n128k16`` with A from shared memory or
from registers (B from shared memory), nine products per commit and a wait
that leaves one group in flight, as the bf16 conv kernels issue them, from 1,
2 and 4 warpgroups an SM; each with nothing else in the loop. These are the
ceilings the attention and conv kernels are read against. Needs CUDA and
nvcc; fails without.
"""
from __future__ import annotations

import os
import subprocess
import sys

from ..ops import native


def main() -> int:
    source = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mma_rates.cu")
    os.makedirs(native.BUILD_DIR, exist_ok=True)
    binary = os.path.join(native.BUILD_DIR, "mma_rates")
    subprocess.run([native._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
                    "-O3", "-o", binary, source], check=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    return subprocess.run([binary]).returncode


if __name__ == "__main__":
    sys.exit(main())
