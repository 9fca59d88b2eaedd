"""Build, bind and launch the hand-written FD3D CUDA kernel (``csrc/fd3d.cu``).

The kernel replaces the Pallas TPU kernel
``src/repro/kernels/fd3d/fd3d.py::fd3d_pallas``.  It is compiled by ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface at first use,
into ``_build/`` beside this file (git-ignored), and loaded with ``ctypes``.
The library is named by a hash of the source and the flags, so an edited
source builds anew.  Nothing here runs at import: a machine without ``nvcc``
or a card imports this module and fails only when it asks for a launch.

There is no fallback: a missing ``nvcc``, a failed build or a failed launch
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = ["build", "fd3d_cuda"]

SOURCE = Path(__file__).resolve().parent / "csrc" / "fd3d.cu"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None

# Kernel launches since import (or since a caller reset it to 0): one per
# successful launch in ``fd3d_cuda``, and nowhere else.
launches = 0
# What nvcc/ptxas printed for the build this process did ("" if the library
# was already on disk).
build_log = ""


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(candidate):
        return candidate
    raise RuntimeError("nvcc not found (not on PATH, nor under $CUDA_HOME/bin)")


def build() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib, build_log
    with _lock:
        if _lib is not None:
            return _lib
        tag = hashlib.sha256(
            SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        so = BUILD_DIR / f"libfd3d_{tag}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}) on {SOURCE}:\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            build_log = proc.stdout + proc.stderr
            os.replace(tmp, so)  # atomic: a concurrent build never sees half a file
        lib = ctypes.CDLL(str(so))
        fn = lib.fd3d_step
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_float,
            ctypes.c_int, ctypes.c_void_p,
        ]
        fn.restype = ctypes.c_int
        _lib = lib
        return lib


def _check(u: torch.Tensor, u_prev: torch.Tensor, c2dt2: torch.Tensor) -> None:
    if u.dim() != 3 or min(u.shape) < 1:
        raise ValueError(f"u must be (NZ, NY, NX) with every axis >= 1, got {tuple(u.shape)}")
    if max(u.shape) > 2**31 - 1:
        raise ValueError(f"axis too long for int32 indexing: {tuple(u.shape)}")
    for name, t in (("u_prev", u_prev), ("c2dt2", c2dt2)):
        if t.shape != u.shape:
            raise ValueError(f"{name} shape {tuple(t.shape)} != u shape {tuple(u.shape)}")
        if t.dtype != u.dtype:
            raise ValueError(f"{name} dtype {t.dtype} != u dtype {u.dtype}")
        if t.device != u.device:
            raise ValueError(f"{name} on {t.device}, u on {u.device}")
    if u.dtype not in _DTYPE_CODE:
        raise ValueError(f"dtype {u.dtype} not supported (float32, bfloat16)")
    for name, t in (("u", u), ("u_prev", u_prev), ("c2dt2", c2dt2)):
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if u.device.type != "cuda":
        raise ValueError(f"the FD3D kernel needs CUDA tensors, got {u.device}")


def fd3d_cuda(
    u: torch.Tensor, u_prev: torch.Tensor, c2dt2: torch.Tensor, *, dx: float
) -> torch.Tensor:
    """One fused leapfrog step on the card; launches on the current stream."""
    global launches
    _check(u, u_prev, c2dt2)
    lib = build()
    out = torch.empty_like(u)
    nz, ny, nx = u.shape
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        err = lib.fd3d_step(
            u.data_ptr(), u_prev.data_ptr(), c2dt2.data_ptr(), out.data_ptr(),
            nz, ny, nx, float(dx * dx), _DTYPE_CODE[u.dtype], stream,
        )
    if err != 0:
        raise RuntimeError(f"FD3D kernel launch failed with CUDA error {err}")
    with _lock:
        launches += 1
    return out
