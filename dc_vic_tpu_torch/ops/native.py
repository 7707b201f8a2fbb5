"""Build and load the port's native libraries.

Two shared libraries with plain C interfaces, loaded with ctypes and built
into ``dc_vic_tpu_torch/_build/`` at first use (and again whenever a source
is newer than its library):

* ``libdcvic_kernels.so``: the CUDA kernels under ``csrc/``, compiled for
  ``sm_90a`` with ``nvcc``. Only a call on a CUDA tensor builds it.
* ``libdcvic_rans.so``: the host rANS coder, compiled with ``g++`` from the
  JAX package's ``dc_vic_tpu/ops/rans/rans.cpp`` by path, so both packages
  code with one source.

Builds write to a temporary file under an exclusive file lock and rename it
into place, so concurrent processes (test workers) never load a partial
library. A failed build raises with the compiler's output.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
CSRC = os.path.join(_PKG, "csrc")
CUDA_SOURCES = [os.path.join(CSRC, "vq_argmin.cu"),
                os.path.join(CSRC, "flash_attn_f32.cu")]
RANS_SOURCE = os.path.join(os.path.dirname(_PKG), "dc_vic_tpu", "ops", "rans",
                           "rans.cpp")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# compiler output of the builds this process ran (ptxas register/smem report)
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _build(name: str, sources: List[str],
           command: Callable[[str], List[str]]) -> str:
    """Build ``name`` from ``sources`` unless an up-to-date copy exists.
    ``command(out_path)`` gives the compiler invocation."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, name)
    newest = max(os.path.getmtime(s) for s in sources)
    with open(path + ".lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if os.path.exists(path) and os.path.getmtime(path) >= newest:
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        proc = subprocess.run(command(tmp), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"building {name} failed (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        build_logs[name] = proc.stdout + proc.stderr
        os.replace(tmp, path)
    return path


def _load(name: str, build: Callable[[], str],
          bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(build())
            bind(lib)
            _libs[name] = lib
        return _libs[name]


def _bind_kernels(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dcvic_vq_argmin.restype = i
    lib.dcvic_vq_argmin.argtypes = [p, p, p, i, i, i, p]
    lib.dcvic_flash_attn_f32.restype = i
    lib.dcvic_flash_attn_f32.argtypes = [p, p, p, p, i, i, i, p]


def kernels() -> ctypes.CDLL:
    """The CUDA kernel library (built with nvcc for sm_90a on first use)."""
    return _load("libdcvic_kernels.so", lambda: _build(
        "libdcvic_kernels.so", CUDA_SOURCES,
        lambda out: [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
                     "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v", "-o", out, *CUDA_SOURCES]),
        _bind_kernels)


def _bind_rans(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.dcvic_rans_table_new.restype = p
    lib.dcvic_rans_table_new.argtypes = [p, i, i, p, p]
    lib.dcvic_rans_table_free.restype = None
    lib.dcvic_rans_table_free.argtypes = [p]
    lib.dcvic_rans_encode_with_indexes.restype = i
    lib.dcvic_rans_encode_with_indexes.argtypes = [p, p, i, p, p, i]
    lib.dcvic_rans_decode_with_indexes.restype = None
    lib.dcvic_rans_decode_with_indexes.argtypes = [p, i, p, i, p, p]
    lib.dcvic_rans_decoder_new.restype = p
    lib.dcvic_rans_decoder_new.argtypes = [p, i]
    lib.dcvic_rans_decoder_free.restype = None
    lib.dcvic_rans_decoder_free.argtypes = [p]
    lib.dcvic_rans_decode_stream.restype = None
    lib.dcvic_rans_decode_stream.argtypes = [p, p, i, p, p]


def rans() -> ctypes.CDLL:
    """The host rANS coder (built with g++ from the JAX package's source)."""
    return _load("libdcvic_rans.so", lambda: _build(
        "libdcvic_rans.so", [RANS_SOURCE],
        lambda out: ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
                     "-fPIC", "-o", out, RANS_SOURCE]),
        _bind_rans)


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
