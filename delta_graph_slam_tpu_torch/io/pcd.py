"""Minimal PCD (Point Cloud Data) writer/reader.

A copy of delta_graph_slam_tpu/io/pcd.py (numpy, host side).

save_map writes map.pcd / b_map.pcd / aligned_b_map.pcd
(delta_graph_slam_nodelet.cpp:1197-1201 via
pcl::io::savePCDFileBinary); this module produces compatible binary or
ascii PCD v0.7 files for xyz clouds.
"""

import numpy as np

_HEADER = """# .PCD v0.7 - Point Cloud Data file format
VERSION 0.7
FIELDS x y z
SIZE 4 4 4
TYPE F F F
COUNT 1 1 1
WIDTH {n}
HEIGHT 1
VIEWPOINT 0 0 0 1 0 0 0
POINTS {n}
DATA {data}
"""


def save_pcd(path, points, binary=True):
    pts = np.asarray(points, np.float32).reshape(-1, 3)
    header = _HEADER.format(n=len(pts), data="binary" if binary else "ascii")
    if binary:
        with open(path, "wb") as f:
            f.write(header.encode("ascii"))
            f.write(pts.tobytes())
    else:
        with open(path, "w") as f:
            f.write(header)
            for p in pts:
                f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")


def load_pcd(path):
    with open(path, "rb") as f:
        raw = f.read()
    # split header from data
    lines = []
    pos = 0
    while True:
        nl = raw.index(b"\n", pos)
        line = raw[pos:nl].decode("ascii", errors="replace")
        lines.append(line)
        pos = nl + 1
        if line.startswith("DATA"):
            break
    meta = {}
    for line in lines:
        parts = line.split()
        if parts:
            meta[parts[0]] = parts[1:]
    n = int(meta["POINTS"][0])
    fields = meta["FIELDS"]
    if fields[:3] != ["x", "y", "z"]:
        raise ValueError(f"unsupported PCD fields: {fields}")
    nf = len(fields)
    if meta["DATA"][0] == "binary":
        arr = np.frombuffer(raw, np.float32, count=n * nf, offset=pos)
        return arr.reshape(n, nf)[:, :3].copy()
    arr = np.loadtxt(raw[pos:].decode("ascii").splitlines(), dtype=np.float32)
    return np.atleast_2d(arr)[:, :3]
