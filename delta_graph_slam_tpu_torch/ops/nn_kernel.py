"""Wrapper of the Hopper 1-NN kernel (counterpart of ops/pallas_nn.py).

The kernel (csrc/nn1.cu) is compiled with nvcc for sm_90a into a shared
library with a plain C interface, at first use, and loaded with ctypes.
The library lives in the git-ignored ``_build/`` directory of this
package, keyed by a hash of the source and the flags, so a fresh checkout
builds it from the sources alone. Its plain PyTorch version is
``ops/knn.py:nn_1_reference``; ``ops/knn.py:nn_1`` dispatches between
the two by the device of the tensors.

``launch_geometry`` is the host half of the kernel's design: how many
ways the target axis is split (blocks of one cluster) for each query
tile. It is plain Python, so the CPU tests reach it.
"""

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "nn1.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Mirrors of the constants of csrc/nn1.cu: queries a block owns (threads x
# queries per thread), targets a staged tile holds, and the most splits of
# the target axis (the portable cluster size).
QUERIES_PER_BLOCK = 128 * 4
TILE = 512
MAX_SPLITS = 8
# Blocks an SM should get, at least: enough to balance the card, few
# enough to keep each split many tiles long (every cluster pays a merge).
BLOCKS_PER_SM = 2

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
    The compiler's report (ptxas: registers, shared memory, spills) goes
    beside it, in ``<library>.log``.
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
    out.with_name(out.name + ".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


def launch_geometry(n: int, m: int, sm_count: int):
    """(splits, q_tiles) of one launch for n queries and m targets.

    The query axis gives q_tiles blocks; each gets ``splits`` blocks (one
    cluster), split s scanning the target tiles s, s + splits, ...: the
    largest power of two up to MAX_SPLITS that keeps the grid within
    BLOCKS_PER_SM blocks an SM (at least one split), and never more
    splits than target tiles, so that every split has a tile.
    """
    if n < 1 or m < 0 or sm_count < 1:
        raise ValueError(f"bad geometry request: n={n} m={m} sm_count={sm_count}")
    q_tiles = math.ceil(n / QUERIES_PER_BLOCK)
    splits = 1
    while splits * 2 <= min(BLOCKS_PER_SM * sm_count / q_tiles, MAX_SPLITS):
        splits *= 2
    return min(splits, max(1, math.ceil(m / TILE))), q_tiles


_sm_counts = {}


def sm_count(device) -> int:
    if device not in _sm_counts:
        _sm_counts[device] = torch.cuda.get_device_properties(device).multi_processor_count
    return _sm_counts[device]


def _library():
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            fn = lib.dgs_nn1
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
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
    splits, _ = launch_geometry(n, m, sm_count(device))
    lib = _library()
    packed = torch.empty((max(m, 1), 4), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.dgs_nn1(
            query.data_ptr(), qmask.data_ptr(), n,
            target.data_ptr(), tmask.data_ptr(), m,
            int(bool(exclude_self)), splits, packed.data_ptr(),
            d2.data_ptr(), idx.data_ptr(), stream,
        )
    if err != 0:
        raise RuntimeError(f"nn1 kernel launch failed: cudaError {err}")
    with _lock:     # the threaded runner launches from more than one thread
        launches += 1
    return d2, idx


def tie_case(rng, n=3000, copies=4):
    """Host inputs (query, qmask, target, tmask) that hold the tie rule:
    queries near a 16 x 16 x 8 grid of 1 m cells, and the grid repeated
    ``copies`` times as targets, so every query's minimum is reached by
    ``copies`` equal targets 2048 slots apart (four tiles: other splits of
    the launch). Coordinates are multiples of 1/8 m, so every distance is
    exact in float32 and the nearest grid point is unique: the kernel and
    the plain version must both return the first copy."""
    g = np.stack(np.meshgrid(np.arange(16), np.arange(16), np.arange(8),
                             indexing="ij"), -1).reshape(-1, 3) - [8, 8, 4]
    base = g.astype(np.float32)
    pick = rng.integers(0, len(base), n)
    q = base[pick] + rng.integers(-3, 4, (n, 3)) / np.float32(8)
    t = np.tile(base, (copies, 1))
    return (q.astype(np.float32), np.ones(n, bool), t, np.ones(len(t), bool))
