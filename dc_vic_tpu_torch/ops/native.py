"""Build and load the port's native libraries.

Two shared libraries with plain C interfaces, loaded with ctypes and built
into ``dc_vic_tpu_torch/_build/`` at first use (and again whenever a source
is newer than its library):

* ``libdcvic_kernels.so``: the CUDA kernels under ``csrc/``, compiled for
  ``sm_90a`` with one ``nvcc`` per source, all started together, and linked
  once. Only a call on a CUDA tensor builds it.
* ``libdcvic_rans.so``: the host rANS coder, compiled with ``g++`` from
  ``csrc/rans.cpp``, the port's own copy of the JAX package's coder source
  (a test keeps the two byte-equal).

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
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
CSRC = os.path.join(_PKG, "csrc")
CUDA_SOURCES = [os.path.join(CSRC, name) for name in (
    "vq_argmin.cu", "flash_attn_f32.cu", "gn.cu", "conv3x3.cu", "conv3x3_bf16.cu",
    "rans_device.cu", "launch_floor.cu")]
# included by the sources above; a change rebuilds the library
CUDA_HEADERS = [os.path.join(CSRC, "tf32x3.cuh")]
RANS_SOURCE = os.path.join(CSRC, "rans.cpp")

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


def _run(command: List[str], name: str) -> str:
    proc = subprocess.run(command, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"building {name} failed (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}")
    return proc.stdout + proc.stderr


def _build(name: str, sources: List[str],
           compile_to: Callable[[str], str]) -> str:
    """Build ``name`` from ``sources`` unless an up-to-date copy exists.
    ``compile_to(out_path)`` writes the library and returns the compilers'
    output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    path = os.path.join(BUILD_DIR, name)
    newest = max(os.path.getmtime(s) for s in sources)
    with open(path + ".lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if os.path.exists(path) and os.path.getmtime(path) >= newest:
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        build_logs[name] = compile_to(tmp)
        os.replace(tmp, path)
    return path


def _compile_kernels(out: str) -> str:
    """One nvcc per source, all started together, then one link."""
    nvcc = _nvcc()
    flags = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
    objects = [f"{out}.{os.path.basename(src)}.o" for src in CUDA_SOURCES]
    with ThreadPoolExecutor(len(CUDA_SOURCES)) as pool:
        logs = list(pool.map(
            lambda so: _run([nvcc, *flags, "-c", "-o", so[1], so[0]],
                            os.path.basename(so[0])),
            zip(CUDA_SOURCES, objects)))
    logs.append(_run([nvcc, "-shared", "-o", out, *objects], "libdcvic_kernels.so"))
    for obj in objects:
        os.remove(obj)
    return "".join(logs)


def _load(name: str, build: Callable[[], str],
          bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(build())
            bind(lib)
            _libs[name] = lib
        return _libs[name]


def _bind_kernels(lib: ctypes.CDLL) -> None:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.dcvic_vq_argmin.restype = i
    lib.dcvic_vq_argmin.argtypes = [p, p, p, i, i, i, ll, ll, ll, i, p]
    lib.dcvic_flash_attn_f32.restype = i
    lib.dcvic_flash_attn_f32.argtypes = [p, p, p, p, i, i, i, p]
    lib.dcvic_flash_attn_f32_smem.restype = i
    lib.dcvic_flash_attn_f32_smem.argtypes = [i]
    lib.dcvic_gn_channel_sums.restype = i
    lib.dcvic_gn_channel_sums.argtypes = [p, p, i, i, ll, i, p]
    lib.dcvic_gn_apply.restype = i
    lib.dcvic_gn_apply.argtypes = [p, p, p, p, i, i, ll, i, i, p]
    lib.dcvic_gn_fold_chunks.restype = ll
    lib.dcvic_gn_fold_chunks.argtypes = [ll, i]
    lib.dcvic_gn_fold.restype = i
    lib.dcvic_gn_fold.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, ll, ctypes.c_float, i, i,
                                  p]
    lib.dcvic_conv3x3_same.restype = i
    lib.dcvic_conv3x3_same.argtypes = [p, p, p, p, i, i, i, i, i, i, p]
    lib.dcvic_conv3x3_gn_swish.restype = i
    lib.dcvic_conv3x3_gn_swish.argtypes = [p, p, p, p, p, p, p, p,
                                           i, i, i, i, i, i, p]
    lib.dcvic_repack_weights_bf16.restype = i
    lib.dcvic_repack_weights_bf16.argtypes = [p, p, i, i, p]
    lib.dcvic_conv3x3_same_bf16.restype = i
    lib.dcvic_conv3x3_same_bf16.argtypes = [p, p, p, p, i, i, i, i, i, p]
    lib.dcvic_conv3x3_gn_swish_bf16.restype = i
    lib.dcvic_conv3x3_gn_swish_bf16.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, p]
    lib.dcvic_launch_floor.restype = i
    lib.dcvic_launch_floor.argtypes = [i, i, p]
    lib.dcvic_rans_encode_pack.restype = i
    lib.dcvic_rans_encode_pack.argtypes = [p, i, p, p, p, p, i, i, i, i, i, i, i,
                                           p, p, p, i, p, i, p, p, p, p]
    lib.dcvic_rans_decode_section.restype = i
    lib.dcvic_rans_decode_section.argtypes = [p, ll, p, p, p, p, p, p, p, p, p, p, i,
                                              i, i, i, i, i, i, i, i, p, p, p, p, p]


def kernels() -> ctypes.CDLL:
    """The CUDA kernel library (built with nvcc for sm_90a on first use)."""
    return _load("libdcvic_kernels.so", lambda: _build(
        "libdcvic_kernels.so", CUDA_SOURCES + CUDA_HEADERS, _compile_kernels),
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
    lib.dcvic_tpu_encode_stream.restype = i
    lib.dcvic_tpu_encode_stream.argtypes = [p, p, p, i, i, p, p, i, p]
    lib.dcvic_tpu_decode_stream.restype = i
    lib.dcvic_tpu_decode_stream.argtypes = [p, i, p, p, i, i, p, p]


def rans() -> ctypes.CDLL:
    """The host rANS coder (built with g++ from ``csrc/rans.cpp``)."""
    return _load("libdcvic_rans.so", lambda: _build(
        "libdcvic_rans.so", [RANS_SOURCE],
        lambda out: _run(["g++", "-O3", "-march=native", "-std=c++17", "-shared",
                          "-fPIC", "-o", out, RANS_SOURCE], "libdcvic_rans.so")),
        _bind_rans)


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
