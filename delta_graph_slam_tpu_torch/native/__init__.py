"""Native (C++) host runtime components, loaded with ctypes.

``pointcloud_io.cpp`` implements the host data path (KITTI ingestion,
binary PCD IO, the scan spool, host voxel thinning). It is host code, not a
device kernel. ``build_library()`` compiles it with ``g++ -O3 -fPIC -shared
-std=c++17`` into the git-ignored ``_build/`` directory of this package,
keyed by a hash of the source and the flags, so a fresh checkout builds it
from its own source; nothing is built in the source directory.

``load_library()`` keeps the reference's contract: it returns None when the
library is unavailable (not built yet and no build asked for, or no
compiler), and then ``load_kitti_bin``, ``save_pcd``, ``load_pcd`` and
``voxel_thin`` take their Python paths (io/kitti.py, io/pcd.py, numpy);
``ScanSpool`` builds the library or raises. ``load_library(build=True)``, or
the environment variable DGS_BUILD_NATIVE, builds it at first use.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("pointcloud_io.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lib = None
_lock = threading.Lock()


def library_path() -> Path:
    """Where the library built from this source and these flags lives."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()
    ).hexdigest()[:16]
    return BUILD_DIR / f"libdgs_pcio_{digest}.so"


def build_library() -> Path:
    """Compile pointcloud_io.cpp unless the library for this source exists.

    The library is written under a temporary name and renamed into place,
    so processes that build at the same time never load a partial file."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: libpcio cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            f"g++ failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)
    return out


def _declare(lib):
    lib.pcio_load_kitti_bin.restype = ctypes.c_int64
    lib.pcio_load_kitti_bin.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float))
    ]
    lib.pcio_free.restype = None
    lib.pcio_free.argtypes = [ctypes.c_void_p]
    lib.pcio_save_pcd.restype = ctypes.c_int
    lib.pcio_save_pcd.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int64
    ]
    lib.pcio_load_pcd.restype = ctypes.c_int64
    lib.pcio_load_pcd.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float))
    ]
    lib.pcio_voxel_thin.restype = ctypes.c_int64
    lib.pcio_voxel_thin.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_float,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
    ]
    lib.pcio_spool_create.restype = ctypes.c_void_p
    lib.pcio_spool_create.argtypes = [ctypes.c_char_p]
    lib.pcio_spool_append.restype = ctypes.c_int
    lib.pcio_spool_append.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64,
    ]
    lib.pcio_spool_close.restype = None
    lib.pcio_spool_close.argtypes = [ctypes.c_void_p]
    lib.pcio_spool_open.restype = ctypes.c_void_p
    lib.pcio_spool_open.argtypes = [ctypes.c_char_p]
    lib.pcio_spool_size.restype = ctypes.c_int64
    lib.pcio_spool_size.argtypes = [ctypes.c_void_p]
    lib.pcio_spool_stamp.restype = ctypes.c_double
    lib.pcio_spool_stamp.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.pcio_spool_count.restype = ctypes.c_int64
    lib.pcio_spool_count.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.pcio_spool_read.restype = ctypes.c_int
    lib.pcio_spool_read.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_float)
    ]
    return lib


def load_library(build=None):
    """Load (optionally building) libpcio; returns None if unavailable."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            if not (build or (build is None and os.environ.get("DGS_BUILD_NATIVE"))):
                return None
            try:
                path = build_library()
            except (RuntimeError, OSError):
                return None
        _lib = _declare(ctypes.CDLL(str(path)))
        return _lib


def _take_array(lib, ptr, n):
    arr = np.ctypeslib.as_array(ptr, shape=(n, 3)).copy()
    lib.pcio_free(ptr)
    return arr


def _float_ptr(pts):
    return pts.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _points(points):
    return np.ascontiguousarray(np.asarray(points, np.float32).reshape(-1, 3))


def load_kitti_bin(path):
    lib = load_library()
    if lib is None:
        from ..io.kitti import load_kitti_velodyne_bin

        return load_kitti_velodyne_bin(path)
    out = ctypes.POINTER(ctypes.c_float)()
    n = lib.pcio_load_kitti_bin(os.fsencode(path), ctypes.byref(out))
    if n < 0:
        raise IOError(f"pcio_load_kitti_bin failed for {path}")
    if n == 0:
        return np.zeros((0, 3), np.float32)
    return _take_array(lib, out, n)


def save_pcd(path, points):
    lib = load_library()
    pts = _points(points)
    if lib is None:
        from ..io.pcd import save_pcd as py_save

        return py_save(path, pts)
    if lib.pcio_save_pcd(os.fsencode(path), _float_ptr(pts), len(pts)) != 0:
        raise IOError(f"pcio_save_pcd failed for {path}")


def load_pcd(path):
    lib = load_library()
    if lib is not None:
        out = ctypes.POINTER(ctypes.c_float)()
        n = lib.pcio_load_pcd(os.fsencode(path), ctypes.byref(out))
        if n >= 0:
            return _take_array(lib, out, n) if n else np.zeros((0, 3), np.float32)
        if n != -2:
            raise IOError(f"pcio_load_pcd failed for {path}")
    # no library, or a field layout other than exactly x y z (-2): the
    # Python reader handles any layout
    from ..io.pcd import load_pcd as py_load

    return py_load(path)


def voxel_thin(points, resolution):
    """Host-side exact voxel-centroid thinning (pre-upload size bound)."""
    lib = load_library()
    pts = _points(points)
    if lib is None:
        keys = np.floor(pts / resolution).astype(np.int64)
        uniq, inv = np.unique(keys, axis=0, return_inverse=True)
        inv = inv.reshape(-1)
        sums = np.zeros((len(uniq), 3))
        np.add.at(sums, inv, pts)
        return (sums / np.bincount(inv)[:, None]).astype(np.float32)
    out = ctypes.POINTER(ctypes.c_float)()
    n = lib.pcio_voxel_thin(_float_ptr(pts), len(pts), resolution, ctypes.byref(out))
    if n < 0:
        raise RuntimeError("pcio_voxel_thin failed")
    if n == 0:
        return np.zeros((0, 3), np.float32)
    return _take_array(lib, out, n)


class ScanSpool:
    """Packed scan store (write once, replay fast) backed by libpcio."""

    def __init__(self, path, mode="r"):
        lib = load_library(build=True)
        if lib is None:
            raise RuntimeError("native libpcio unavailable")
        self._lib = lib
        self.mode = mode
        if mode == "w":
            self._h = lib.pcio_spool_create(os.fsencode(path))
        else:
            self._h = lib.pcio_spool_open(os.fsencode(path))
        if not self._h:
            raise IOError(f"cannot open spool {path}")

    def append(self, stamp, points):
        pts = _points(points)
        if self._lib.pcio_spool_append(self._h, float(stamp), _float_ptr(pts),
                                       len(pts)) != 0:
            raise IOError("spool append failed")

    def __len__(self):
        return int(self._lib.pcio_spool_size(self._h))

    def _index(self, i):
        if not 0 <= i < len(self):
            raise IndexError(f"spool record {i} of {len(self)}")
        return i

    def stamp(self, i):
        return float(self._lib.pcio_spool_stamp(self._h, self._index(i)))

    def read(self, i):
        i = self._index(i)
        n = int(self._lib.pcio_spool_count(self._h, i))
        buf = np.empty((n, 3), np.float32)
        if self._lib.pcio_spool_read(self._h, i, _float_ptr(buf)) != 0:
            raise IOError("spool read failed")
        return buf

    def close(self):
        if self._h:
            self._lib.pcio_spool_close(self._h)
            self._h = None
