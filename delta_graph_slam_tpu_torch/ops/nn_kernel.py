"""Wrapper of the Hopper 1-NN kernel (counterpart of ops/pallas_nn.py).

The kernel (csrc/nn1.cu) is compiled with nvcc for sm_90a into a shared
library with a plain C interface, at first use, and loaded with ctypes.
The library lives in the git-ignored ``_build/`` directory of this
package, keyed by a hash of the source and the flags, so a fresh checkout
builds it from the sources alone. Its plain PyTorch version is
``ops/knn.py:nn_1_reference``; ``ops/knn.py:nn_1`` dispatches between
the two by the device of the tensors.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "nn1.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

# Kernel launches since import (or since the caller last reset it): a run
# reads it to show that its main path went through the kernel.
launches = 0

_lib = None
_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found: the 1-NN kernel cannot be built")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libdgs_nn1_{digest}.so"


def build() -> Path:
    """Compile csrc/nn1.cu unless the library for this source exists.

    The library is written under a temporary name and renamed into place,
    so processes that build at the same time never load a partial file.
    """
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)
    return out


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.dgs_nn1
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            _lib = lib
    return _lib


def _check_points(name, x, device):
    if not x.is_cuda or x.device != device:
        raise ValueError(f"{name} must be on {device}, got {x.device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"{name} must be (N, 3), got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_mask(name, mask, n, device):
    if mask.device != device:
        raise ValueError(f"{name} must be on {device}, got {mask.device}")
    if mask.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"{name} must be bool or uint8, got {mask.dtype}")
    if mask.shape != (n,):
        raise ValueError(f"{name} must be ({n},), got {tuple(mask.shape)}")
    if not mask.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def nn_1_cuda(query, qmask, target, tmask, *, exclude_self=False):
    """Exact 1-NN on the card. Returns (d2 (N,) float32, idx (N,) int32).

    Same contract as ops/knn.py:nn_1, except that an invalid query gets
    idx = 0 (the plain version leaves its index unmasked).
    """
    global launches
    device = query.device
    _check_points("query", query, device)
    _check_points("target", target, device)
    n, m = query.shape[0], target.shape[0]
    _check_mask("qmask", qmask, n, device)
    _check_mask("tmask", tmask, m, device)
    if max(n, m) >= 2**31 // 3:
        raise ValueError(f"too many points for int32 indexing: {n}, {m}")
    d2 = torch.empty((n,), dtype=torch.float32, device=device)
    idx = torch.empty((n,), dtype=torch.int32, device=device)
    if n == 0:
        return d2, idx
    lib = _library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.dgs_nn1(
            query.data_ptr(), qmask.data_ptr(), n,
            target.data_ptr(), tmask.data_ptr(), m,
            int(bool(exclude_self)), d2.data_ptr(), idx.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"nn1 kernel launch failed: cudaError {err}")
    launches += 1
    return d2, idx
