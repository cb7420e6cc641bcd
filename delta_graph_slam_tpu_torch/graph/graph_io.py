"""Pose-graph save/load: g2o text format + robust-kernel sidecar.

Interop with the reference's GraphSLAM::save/load (graph_slam.cpp:354-380):
the graph is written as standard g2o text (VERTEX_SE2/EDGE_SE2 + the
custom prior tags registered at graph_slam.cpp:36-48) plus a ``.kernels``
sidecar mapping each edge's vertex-id signature to its robust kernel type
and width (robust_kernel_io.cpp:46-151). save_npz/load_npz write the
padded tables as arrays. The files are the JAX package's formats, so
either package reads what the other wrote. save_g2o_se3/load_g2o_se3 are
the SE3 counterparts (VERTEX_SE3:QUAT / EDGE_SE3:QUAT, VERTEX_PLANE and
EDGE_SE3_PLANE).
"""

import numpy as np

from ..utils.device import DEFAULT_DEVICE
from .robust import ROBUST_KERNELS
from .se2_graph import SE2GraphBuilder
from .se3_graph import SE3GraphBuilder


def _info_upper(info):
    info = np.asarray(info, float)
    d = info.shape[0]
    return " ".join(
        f"{info[i, j]:.12g}" for i in range(d) for j in range(i, d)
    )


def save_g2o(builder: SE2GraphBuilder, path):
    """Write VERTEX_SE2 / EDGE_SE2 / EDGE_SE2_PriorXY / EDGE_SE2_PRIORQUAT
    lines plus the .kernels sidecar."""
    lines = []
    for vid, (pose, fixed) in enumerate(zip(builder.poses, builder.fixed)):
        lines.append(
            f"VERTEX_SE2 {vid} {pose[0]:.12g} {pose[1]:.12g} {pose[2]:.12g}"
        )
        if fixed:
            lines.append(f"FIX {vid}")
    kernel_lines = []
    for e in builder.edges:
        if e["type"] == "se2":
            m = e["meas"]
            lines.append(
                f"EDGE_SE2 {e['i']} {e['j']} {m[0]:.12g} {m[1]:.12g} "
                f"{m[2]:.12g} {_info_upper(e['info'])}"
            )
            sig = f"2 {e['i']} {e['j']}"
        elif e["type"] == "xy":
            m = e["meas"]
            lines.append(
                f"EDGE_SE2_PriorXY {e['i']} {m[0]:.12g} {m[1]:.12g} "
                f"{_info_upper(e['info'])}"
            )
            sig = f"1 {e['i']}"
        else:  # yaw
            th = float(e["meas"])
            c, s = np.cos(th), np.sin(th)
            info = float(np.asarray(e["info"]).reshape(()))
            lines.append(
                f"EDGE_SE2_PRIORQUAT {e['i']} {c:.12g} {-s:.12g} {s:.12g} "
                f"{c:.12g} {info:.12g}"
            )
            sig = f"1 {e['i']}"
        kname = ROBUST_KERNELS[e["kernel"]]
        if kname != "NONE":
            kernel_lines.append(f"{sig} {kname} {e['delta']:.12g}")
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(str(path) + ".kernels", "w") as f:
        f.write(f"{len(kernel_lines)}\n")
        f.write("\n".join(kernel_lines) + ("\n" if kernel_lines else ""))


def _read_kernels(path):
    """The .kernels sidecar as {(n_vertices, ids...): (kernel name, width)};
    empty when the file is absent."""
    kernels = {}
    try:
        with open(str(path) + ".kernels") as f:
            f.readline()
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                nv = int(parts[0])
                sig = (nv,) + tuple(int(x) for x in parts[1 : 1 + nv])
                kernels[sig] = (parts[1 + nv], float(parts[2 + nv]))
    except FileNotFoundError:
        pass
    return kernels


def load_g2o(path, device=DEFAULT_DEVICE) -> SE2GraphBuilder:
    """Parse the subset written by save_g2o (plus FIX lines)."""
    b = SE2GraphBuilder(device=device)
    kernels = _read_kernels(path)

    fixed_ids = set()
    edges = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "VERTEX_SE2":
                b.add_vertex([float(parts[2]), float(parts[3]), float(parts[4])])
            elif tag == "FIX":
                fixed_ids.add(int(parts[1]))
            elif tag in ("EDGE_SE2", "EDGE_SE2_PriorXY", "EDGE_SE2_PRIORQUAT"):
                edges.append(parts)
    for vid in fixed_ids:
        b.set_fixed(vid, True)
    for parts in edges:
        tag = parts[0]
        if tag == "EDGE_SE2":
            i, j = int(parts[1]), int(parts[2])
            m = [float(x) for x in parts[3:6]]
            u = [float(x) for x in parts[6:12]]
            info = np.array([
                [u[0], u[1], u[2]],
                [u[1], u[3], u[4]],
                [u[2], u[4], u[5]],
            ])
            k, d = kernels.get((2, i, j), ("NONE", 1.0))
            b.add_se2_edge(i, j, m, info, kernel=k, delta=d)
        elif tag == "EDGE_SE2_PriorXY":
            i = int(parts[1])
            m = [float(parts[2]), float(parts[3])]
            u = [float(x) for x in parts[4:7]]
            info = np.array([[u[0], u[1]], [u[1], u[2]]])
            k, d = kernels.get((1, i), ("NONE", 1.0))
            b.add_prior_xy(i, m, info, kernel=k, delta=d)
        else:
            i = int(parts[1])
            R = [float(x) for x in parts[2:6]]
            th = float(np.arctan2(R[2], R[0]))
            info = float(parts[6])
            k, d = kernels.get((1, i), ("NONE", 1.0))
            b.add_prior_yaw(i, th, info, kernel=k, delta=d)
    return b


def save_g2o_se3(builder: SE3GraphBuilder, path):
    """SE3 graph as standard g2o text (VERTEX_SE3:QUAT / EDGE_SE3:QUAT,
    plus VERTEX_PLANE and the custom tags for the rest; kernels sidecar)."""
    lines = []
    for vid, (pose, fixed) in enumerate(zip(builder.poses, builder.fixed)):
        t = pose[:3]
        q = pose[3:7]  # wxyz -> g2o writes x y z w
        lines.append(
            f"VERTEX_SE3:QUAT {vid} "
            f"{t[0]:.12g} {t[1]:.12g} {t[2]:.12g} "
            f"{q[1]:.12g} {q[2]:.12g} {q[3]:.12g} {q[0]:.12g}"
        )
        if fixed:
            lines.append(f"FIX {vid}")
    nv = len(builder.poses)
    for pid, coeffs in enumerate(builder.planes):
        lines.append(
            "VERTEX_PLANE "
            + f"{nv + pid} "
            + " ".join(f"{c:.12g}" for c in coeffs)
        )
    kernel_lines = []
    for e in builder.edges:
        if e["type"] == "se3":
            m = e["meas"]  # [t, q wxyz]
            lines.append(
                f"EDGE_SE3:QUAT {e['i']} {e['j']} "
                f"{m[0]:.12g} {m[1]:.12g} {m[2]:.12g} "
                f"{m[4]:.12g} {m[5]:.12g} {m[6]:.12g} {m[3]:.12g} "
                + _info_upper(e["info"])
            )
            sig = f"2 {e['i']} {e['j']}"
            kname = ROBUST_KERNELS[e["kernel"]]
            if kname != "NONE":
                kernel_lines.append(f"{sig} {kname} {e['delta']:.12g}")
        elif e["type"] == "se3plane":
            m = e["meas"]
            lines.append(
                f"EDGE_SE3_PLANE {e['i']} {nv + e['p']} "
                + " ".join(f"{x:.12g}" for x in m)
                + " " + _info_upper(e["info"])
            )
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    with open(str(path) + ".kernels", "w") as f:
        f.write(f"{len(kernel_lines)}\n")
        f.write("\n".join(kernel_lines) + ("\n" if kernel_lines else ""))


def _sym_from_upper(u, d):
    """Upper-triangular row-major values -> full symmetric (d,d)."""
    M = np.zeros((d, d))
    k = 0
    for i in range(d):
        for j in range(i, d):
            M[i, j] = M[j, i] = u[k]
            k += 1
    return M


def load_g2o_se3(path, device=DEFAULT_DEVICE) -> SE3GraphBuilder:
    """Parse the subset written by save_g2o_se3 (the reference reads its
    dumps back with g2o's load + robust_kernel_io.cpp:46-151; this is the
    SE3 round-trip counterpart of load_g2o)."""
    b = SE3GraphBuilder(device=device)
    kernels = _read_kernels(path)

    fixed_ids = set()
    edges = []
    plane_base = None  # plane vertex ids are written offset by #poses
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            tag = parts[0]
            if tag == "VERTEX_SE3:QUAT":
                t = [float(x) for x in parts[2:5]]
                qx, qy, qz, qw = (float(x) for x in parts[5:9])
                b.add_se3_node(np.asarray(t + [qw, qx, qy, qz]))
            elif tag == "VERTEX_PLANE":
                if plane_base is None:
                    plane_base = int(parts[1])
                b.add_plane_node([float(x) for x in parts[2:6]])
            elif tag == "FIX":
                fixed_ids.add(int(parts[1]))
            elif tag in ("EDGE_SE3:QUAT", "EDGE_SE3_PLANE"):
                edges.append(parts)
    for vid in fixed_ids:
        b.set_fixed(vid, True)
    for parts in edges:
        if parts[0] == "EDGE_SE3:QUAT":
            i, j = int(parts[1]), int(parts[2])
            t = [float(x) for x in parts[3:6]]
            qx, qy, qz, qw = (float(x) for x in parts[6:10])
            u = [float(x) for x in parts[10:31]]
            k, d = kernels.get((2, i, j), ("NONE", 1.0))
            b.add_se3_edge(i, j, np.asarray(t + [qw, qx, qy, qz]),
                           _sym_from_upper(u, 6), kernel=k, delta=d)
        else:  # EDGE_SE3_PLANE i plane_vid coeffs(4) info_upper(6)
            i = int(parts[1])
            p = int(parts[2]) - (plane_base if plane_base is not None
                                 else len(b.poses))
            coeffs = [float(x) for x in parts[3:7]]
            u = [float(x) for x in parts[7:13]]
            b.add_se3_plane_edge(i, p, coeffs, _sym_from_upper(u, 3))
    return b


def save_npz(builder: SE2GraphBuilder, path):
    """Array-native checkpoint (the fast path; poses + full edge tables)."""
    g = builder.to_arrays()
    flat = {}
    flat["poses"] = g.poses.cpu().numpy()
    flat["fixed"] = g.fixed.cpu().numpy()
    flat["vmask"] = g.vmask.cpu().numpy()
    for name, table in (("e", g.edges), ("pxy", g.priors_xy),
                        ("pyaw", g.priors_yaw)):
        for field, val in table._asdict().items():
            flat[f"{name}__{field}"] = val.cpu().numpy()
    np.savez_compressed(path, **flat)


def load_npz(path, device=DEFAULT_DEVICE) -> SE2GraphBuilder:
    # every table read once: an npz member is decompressed at each access
    with np.load(path) as f:
        z = dict(f)
    b = SE2GraphBuilder(device=device)
    nv = int(z["vmask"].sum())
    for v in range(nv):
        b.add_vertex(z["poses"][v], fixed=bool(z["fixed"][v]))
    m = z["e__mask"]
    for k in np.nonzero(m)[0]:
        b.add_se2_edge(
            int(z["e__i"][k]), int(z["e__j"][k]), z["e__meas"][k],
            z["e__info"][k], level=int(z["e__level"][k]),
            kernel=ROBUST_KERNELS[int(z["e__kernel"][k])],
            delta=float(z["e__delta"][k]),
        )
    m = z["pxy__mask"]
    for k in np.nonzero(m)[0]:
        b.add_prior_xy(
            int(z["pxy__i"][k]), z["pxy__meas"][k], z["pxy__info"][k],
            level=int(z["pxy__level"][k]),
            kernel=ROBUST_KERNELS[int(z["pxy__kernel"][k])],
            delta=float(z["pxy__delta"][k]),
        )
    m = z["pyaw__mask"]
    for k in np.nonzero(m)[0]:
        b.add_prior_yaw(
            int(z["pyaw__i"][k]), float(z["pyaw__meas"][k]),
            float(z["pyaw__info"][k]), level=int(z["pyaw__level"][k]),
            kernel=ROBUST_KERNELS[int(z["pyaw__kernel"][k])],
            delta=float(z["pyaw__delta"][k]),
        )
    return b
