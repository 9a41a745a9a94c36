"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into a
shared library with a plain C interface, loaded with ``ctypes``.  The build
runs at first use, into ``catgrasp_tpu_torch/build/`` (git-ignored); the
library name carries a hash of its source, so an edited kernel is rebuilt
and a stale one is never loaded.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

PKG_DIR = os.path.dirname(os.path.dirname(os.path.realpath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "build")
KERNELS = ("box_hits", "march_csg", "fused_rollout", "row_group_norm")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return path


def library_path(name: str) -> str:
    with open(os.path.join(CSRC_DIR, f"{name}.cu"), "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:12]
    return os.path.join(BUILD_DIR, f"lib{name}_{digest}.so")


def _start_build(name: str):
    """Start ``nvcc`` for one kernel; returns (process, output path) or None
    when the library is already built."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return proc, tmp, out


def _finish_build(name: str, job) -> str:
    proc, tmp, out = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all(names=KERNELS) -> dict[str, str]:
    """Compile every kernel at once (one ``nvcc`` per source, all started
    together); returns each kernel's compiler log (``-Xptxas -v`` lists its
    registers and shared memory), empty for a library already built."""
    jobs = {n: _start_build(n) for n in names}
    return {n: (_finish_build(n, j) if j is not None else "") for n, j in jobs.items()}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        job = _start_build(name)
        if job is not None:
            _finish_build(name, job)
        lib = ctypes.CDLL(library_path(name))
        _LIBS[name] = lib
    return lib


def check_cuda(tensor, name: str, dtype, shape=None):
    """Raise unless ``tensor`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape``, where given)."""
    if not tensor.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {tensor.device}")
    if tensor.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {tensor.dtype}")
    if not tensor.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(tensor.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(tensor.shape)}")


def check_status(status: int, name: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` code returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {status}")
