"""SE3 pose graph with plane and point landmarks (hdl_graph_slam parity).

Vertex kinds and their g2o counterparts:
- SE3 pose  (V,7) [t, q(wxyz)]   g2o::VertexSE3 (right-multiplicative updates)
- plane     (P,4) [n, w]          g2o::VertexPlane / Plane3D (coeffs with unit
                                  normal; distance() = -w; local updates are
                                  (azimuth, elevation, distance))
- point     (Q,3)                 g2o::VertexPointXYZ

Edge families mirror the types the reference registers (graph_slam.cpp:36-48
and include/g2o/): EdgeSE3, EdgeSE3PriorXY/XYZ/Vec/Quat, EdgeSE3Plane,
EdgeSE3PointXYZ, EdgePlaneIdentity/Parallel/Perpendicular,
EdgePlanePriorNormal/Distance.

Every function here takes leading batch dimensions and is free of in-place
writes and of branches on tensor values: the solver evaluates the residuals
on whole edge tables, and the tests differentiate them in forward mode to
hold the solver's closed-form Jacobians.
"""

from typing import NamedTuple

import math

import numpy as np
import torch

from ..geom.se3 import quat_to_rot, rot_to_quat, se3_exp, se3_matrix
from ..utils.device import DEFAULT_DEVICE, resolve_device
from .robust import kernel_id


def _T(a):
    return a.transpose(-1, -2)


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _dot(a, b):
    return (a * b).sum(-1)


# --------------------------------------------------------------- plane math

def plane_normalize(coeffs):
    n = torch.linalg.vector_norm(coeffs[..., :3], dim=-1, keepdim=True)
    return coeffs / torch.clamp(n, min=1e-12)


def plane_azimuth(n):
    """atan2(ny, nx), derivative-safe at the pole (nx = ny = 0 -> 0).

    g2o's Plane3D uses plain atan2 with numeric Jacobians; forward-mode
    derivatives need the frozen branch, or a horizontal plane (the floor
    normal [0,0,1] is the common case) gives NaN tangents."""
    xy2 = n[..., 0] ** 2 + n[..., 1] ** 2
    safe = xy2 > 1e-20
    nx = torch.where(safe, n[..., 0], torch.ones_like(xy2))
    ny = torch.where(safe, n[..., 1], torch.zeros_like(xy2))
    return torch.where(safe, torch.atan2(ny, nx), torch.zeros_like(xy2))


def plane_elevation(n):
    xy2 = n[..., 0] ** 2 + n[..., 1] ** 2
    safe = xy2 > 1e-20
    denom = torch.sqrt(torch.where(safe, xy2, torch.ones_like(xy2)))
    half_pi = torch.full_like(xy2, math.pi / 2)
    pole = torch.where(n[..., 2] >= 0, half_pi, -half_pi)
    return torch.where(safe, torch.atan2(n[..., 2], denom), pole)


def plane_rotation(n):
    """g2o Plane3D::rotation(n) = Rz(azimuth) * Ry(-elevation)."""
    az = plane_azimuth(n)
    el = plane_elevation(n)
    ca, sa = torch.cos(az), torch.sin(az)
    ce, se = torch.cos(el), torch.sin(el)
    # Rz(az) @ Ry(-el): maps the x-axis onto the unit normal n
    rows = [
        torch.stack([ca * ce, -sa, -ca * se], -1),
        torch.stack([sa * ce, ca, -sa * se], -1),
        torch.stack([se, torch.zeros_like(ca), ce], -1),
    ]
    return torch.stack(rows, -2)


def plane_oplus(coeffs, delta):
    """g2o Plane3D::oplus: local (azimuth, elevation, distance) update."""
    az, el, dd = delta[..., 0], delta[..., 1], delta[..., 2]
    s, c = torch.sin(el), torch.cos(el)
    n_local = torch.stack([c * torch.cos(az), c * torch.sin(az), s], -1)
    n_new = _mv(plane_rotation(coeffs[..., :3]), n_local)
    d = -coeffs[..., 3] + dd  # distance() = -w
    return plane_normalize(torch.cat([n_new, -d[..., None]], dim=-1))


def plane_ominus(a, b):
    """a.ominus(b): (azimuth, elevation) of b's normal in a's frame; d diff."""
    n = _mv(_T(plane_rotation(a[..., :3])), b[..., :3])
    d = (-a[..., 3]) - (-b[..., 3])
    return torch.stack([plane_azimuth(n), plane_elevation(n), d], -1)


def transform_plane(T, coeffs):
    """g2o operator*(Isometry3, Plane3D): n' = R n; w' = w - t . n'."""
    n2 = _mv(T[..., :3, :3], coeffs[..., :3])
    w2 = coeffs[..., 3] - _dot(T[..., :3, 3], n2)
    return torch.cat([n2, w2[..., None]], dim=-1)


# ------------------------------------------------------------ pose helpers

def pose7_to_matrix(p):
    return se3_matrix(quat_to_rot(p[..., 3:7]), p[..., :3])


def matrix_to_pose7(T):
    return torch.cat([T[..., :3, 3], rot_to_quat(T[..., :3, :3])], dim=-1)


def _pose7_np(pose, dtype):
    """Host (4,4) or (7,) -> (7,) [t, q wxyz] in the builder's dtype."""
    pose = np.asarray(pose, dtype)
    if pose.shape == (4, 4):
        pose = matrix_to_pose7(torch.from_numpy(np.ascontiguousarray(pose))).numpy()
    return np.asarray(pose, dtype)


def pose7_oplus(p, delta):
    """Right-multiplicative update: T' = T @ exp(delta) (g2o VertexSE3)."""
    return matrix_to_pose7(pose7_to_matrix(p) @ se3_exp(delta))


# ---------------------------------------------------------- error functions

def error_se3(pose_i, pose_j, meas):
    """g2o EdgeSE3: toVectorMQT(Z^-1 (Xi^-1 Xj)) = [dt, q_vec (w>=0)]."""
    RiT = _T(quat_to_rot(pose_i[..., 3:7]))
    Rrel = RiT @ quat_to_rot(pose_j[..., 3:7])
    trel = _mv(RiT, pose_j[..., :3] - pose_i[..., :3])
    RzT = _T(quat_to_rot(meas[..., 3:7]))
    td = _mv(RzT, trel - meas[..., :3])
    q = rot_to_quat(RzT @ Rrel)  # canonicalized w >= 0
    return torch.cat([td, q[..., 1:4]], dim=-1)


def error_se3_prior_xy(pose, meas):
    return pose[..., :2] - meas


def error_se3_prior_xyz(pose, meas):
    return pose[..., :3] - meas


def error_se3_prior_vec(pose, meas):
    """meas = [direction(3), measured(3)] both unit: R^-1 dir - measured
    (include/g2o/edge_se3_priorvec.hpp:39-48)."""
    est = _mv(_T(quat_to_rot(pose[..., 3:7])), meas[..., :3])
    return est - meas[..., 3:6]


def error_se3_prior_quat(pose, meas):
    """Sign-aligned quaternion vec difference
    (include/g2o/edge_se3_priorquat.hpp:39-48). meas = quat wxyz."""
    q = pose[..., 3:7]
    q = torch.where((_dot(q, meas) < 0.0)[..., None], -q, q)
    return q[..., 1:4] - meas[..., 1:4]


def error_se3_plane(pose, plane, meas):
    """(T^-1 * plane).ominus(meas) (include/g2o/edge_se3_plane.hpp:40-47)."""
    RT = _T(quat_to_rot(pose[..., 3:7]))
    Tinv = se3_matrix(RT, -_mv(RT, pose[..., :3]))
    return plane_ominus(transform_plane(Tinv, plane), meas)


def error_se3_point(pose, point, meas):
    """g2o EdgeSE3PointXYZ (no offset param): T^-1 p - meas."""
    return _mv(_T(quat_to_rot(pose[..., 3:7])), point - pose[..., :3]) - meas


def error_plane_identity(p1, p2, meas):
    p2 = torch.where((_dot(p1, p2) < 0.0)[..., None], -p2, p2)
    return (p2 - p1) - meas


def error_plane_parallel(p1, p2, meas):
    n1, n2 = p1[..., :3], p2[..., :3]
    n2 = torch.where((_dot(n1, n2) < 0.0)[..., None], -n2, n2)
    return (n2 - n1) - meas


def error_plane_perpendicular(p1, p2, meas):
    def unit(n):
        return n / torch.clamp(torch.linalg.vector_norm(n, dim=-1, keepdim=True),
                               min=1e-12)

    return _dot(unit(p1[..., :3]), unit(p2[..., :3]))[..., None]


def error_plane_prior_normal(p, meas):
    n = p[..., :3]
    n = torch.where((_dot(n, meas) < 0.0)[..., None], -n, n)
    return n - meas


def error_plane_prior_distance(p, meas):
    return (meas - (-p[..., 3]))[..., None]


# ------------------------------------------------------------- edge tables

class SE3Edges(NamedTuple):
    i: torch.Tensor; j: torch.Tensor
    meas: torch.Tensor    # (E,7) [t, q wxyz]
    info: torch.Tensor    # (E,6,6)
    level: torch.Tensor; kernel: torch.Tensor; delta: torch.Tensor
    mask: torch.Tensor


class SE3PriorXYEdges(NamedTuple):
    i: torch.Tensor; meas: torch.Tensor; info: torch.Tensor
    level: torch.Tensor; kernel: torch.Tensor; delta: torch.Tensor
    mask: torch.Tensor


class SE3PriorXYZEdges(NamedTuple):
    i: torch.Tensor; meas: torch.Tensor; info: torch.Tensor
    level: torch.Tensor; kernel: torch.Tensor; delta: torch.Tensor
    mask: torch.Tensor


class SE3PriorVecEdges(NamedTuple):
    i: torch.Tensor; meas: torch.Tensor; info: torch.Tensor
    level: torch.Tensor; kernel: torch.Tensor; delta: torch.Tensor
    mask: torch.Tensor


class SE3PriorQuatEdges(NamedTuple):
    i: torch.Tensor; meas: torch.Tensor; info: torch.Tensor
    level: torch.Tensor; kernel: torch.Tensor; delta: torch.Tensor
    mask: torch.Tensor


class SE3PlaneEdges(NamedTuple):
    i: torch.Tensor; p: torch.Tensor
    meas: torch.Tensor    # (E,4) plane coeffs
    info: torch.Tensor    # (E,3,3)
    level: torch.Tensor; kernel: torch.Tensor; delta: torch.Tensor
    mask: torch.Tensor


class SE3PointEdges(NamedTuple):
    i: torch.Tensor; q: torch.Tensor
    meas: torch.Tensor; info: torch.Tensor
    level: torch.Tensor; kernel: torch.Tensor; delta: torch.Tensor
    mask: torch.Tensor


class PlanePlaneEdges(NamedTuple):
    """identity (4-dim), parallel (3-dim) or perpendicular (1-dim) selected
    by ``kind``: 0=identity, 1=parallel, 2=perpendicular."""
    a: torch.Tensor; b: torch.Tensor
    kind: torch.Tensor
    meas: torch.Tensor    # (E,4) (parallel uses first 3; perpendicular unused)
    info: torch.Tensor    # (E,4,4)
    level: torch.Tensor; kernel: torch.Tensor; delta: torch.Tensor
    mask: torch.Tensor


class PlanePriorEdges(NamedTuple):
    """normal prior (3-dim, kind=0) or distance prior (1-dim, kind=1)."""
    p: torch.Tensor
    kind: torch.Tensor
    meas: torch.Tensor    # (E,3) (distance prior uses meas[:,0])
    info: torch.Tensor    # (E,3,3)
    level: torch.Tensor; kernel: torch.Tensor; delta: torch.Tensor
    mask: torch.Tensor


class SE3Graph(NamedTuple):
    poses: torch.Tensor       # (V,7)
    fixed: torch.Tensor
    vmask: torch.Tensor
    planes: torch.Tensor      # (P,4)
    plane_fixed: torch.Tensor
    plane_mask: torch.Tensor
    points: torch.Tensor      # (Q,3)
    point_fixed: torch.Tensor
    point_mask: torch.Tensor
    edges: SE3Edges
    priors_xy: SE3PriorXYEdges
    priors_xyz: SE3PriorXYZEdges
    priors_vec: SE3PriorVecEdges
    priors_quat: SE3PriorQuatEdges
    se3_plane: SE3PlaneEdges
    se3_point: SE3PointEdges
    plane_plane: PlanePlaneEdges
    plane_priors: PlanePriorEdges


# ------------------------------------------------------------------ builder

class SE3GraphBuilder:
    """Host-side mutable SE3 graph mirroring the GraphSLAM facade helpers
    (graph_slam.hpp:52-123); ``to_arrays`` pads to fixed capacities and
    uploads to ``device``."""

    def __init__(self, dtype=np.float64, device=DEFAULT_DEVICE):
        self.dtype = dtype
        self.device = resolve_device(device)
        self.poses = []
        self.fixed = []
        self.planes = []
        self.plane_fixed = []
        self.points = []
        self.point_fixed = []
        self.edges = []
        self._next_edge_id = 0

    # vertices -------------------------------------------------------------
    def add_se3_node(self, pose, fixed=False) -> int:
        """pose: (4,4) homogeneous or (7,) [t,q wxyz]."""
        self.poses.append(_pose7_np(pose, self.dtype))
        self.fixed.append(bool(fixed))
        return len(self.poses) - 1

    def add_plane_node(self, coeffs, fixed=False) -> int:
        c = np.asarray(coeffs, self.dtype)
        c = c / max(np.linalg.norm(c[:3]), 1e-12)
        self.planes.append(c)
        self.plane_fixed.append(bool(fixed))
        return len(self.planes) - 1

    def add_point_xyz_node(self, xyz, fixed=False) -> int:
        self.points.append(np.asarray(xyz, self.dtype))
        self.point_fixed.append(bool(fixed))
        return len(self.points) - 1

    def set_fixed(self, vid, fixed=True):
        self.fixed[vid] = bool(fixed)

    def set_pose(self, vid, pose):
        self.poses[vid] = _pose7_np(pose, self.dtype)

    @property
    def num_vertices(self):
        return len(self.poses) + len(self.planes) + len(self.points)

    @property
    def num_edges(self):
        return len(self.edges)

    # edges ----------------------------------------------------------------
    def _add(self, etype, **kw):
        eid = self._next_edge_id
        self._next_edge_id += 1
        kw.setdefault("level", 0)
        kw.setdefault("kernel", "NONE")
        kw.setdefault("delta", 1.0)
        kw["kernel"] = kernel_id(kw["kernel"])
        self.edges.append(dict(id=eid, type=etype, **kw))
        return eid

    def add_se3_edge(self, i, j, meas, info, **kw):
        """meas: relative pose i->j as (4,4) or (7,)."""
        return self._add("se3", i=i, j=j, meas=_pose7_np(meas, self.dtype),
                         info=np.asarray(info, self.dtype), **kw)

    def add_se3_prior_xy_edge(self, i, xy, info, **kw):
        return self._add("xy", i=i, meas=np.asarray(xy, self.dtype),
                         info=np.asarray(info, self.dtype), **kw)

    def add_se3_prior_xyz_edge(self, i, xyz, info, **kw):
        return self._add("xyz", i=i, meas=np.asarray(xyz, self.dtype),
                         info=np.asarray(info, self.dtype), **kw)

    def add_se3_prior_vec_edge(self, i, direction, measurement, info, **kw):
        d = np.asarray(direction, self.dtype)
        m = np.asarray(measurement, self.dtype)
        d = d / max(np.linalg.norm(d), 1e-12)
        m = m / max(np.linalg.norm(m), 1e-12)
        return self._add("vec", i=i, meas=np.concatenate([d, m]),
                         info=np.asarray(info, self.dtype), **kw)

    def add_se3_prior_quat_edge(self, i, quat_wxyz, info, **kw):
        q = np.asarray(quat_wxyz, self.dtype)
        if q[0] < 0:
            q = -q
        return self._add("quat", i=i, meas=q,
                         info=np.asarray(info, self.dtype), **kw)

    def add_se3_plane_edge(self, i, p, plane_coeffs, info, **kw):
        c = np.asarray(plane_coeffs, self.dtype)
        c = c / max(np.linalg.norm(c[:3]), 1e-12)
        return self._add("se3plane", i=i, p=p, meas=c,
                         info=np.asarray(info, self.dtype), **kw)

    def add_se3_point_xyz_edge(self, i, q, xyz, info, **kw):
        return self._add("se3point", i=i, q=q, meas=np.asarray(xyz, self.dtype),
                         info=np.asarray(info, self.dtype), **kw)

    def add_plane_identity_edge(self, a, b, meas, info, **kw):
        return self._add("pp", a=a, b=b, kind=0,
                         meas=np.asarray(meas, self.dtype),
                         info=np.asarray(info, self.dtype), **kw)

    def add_plane_parallel_edge(self, a, b, meas, info, **kw):
        return self._add("pp", a=a, b=b, kind=1,
                         meas=np.asarray(meas, self.dtype),
                         info=np.asarray(info, self.dtype), **kw)

    def add_plane_perpendicular_edge(self, a, b, info, **kw):
        return self._add("pp", a=a, b=b, kind=2,
                         meas=np.zeros(3, self.dtype),
                         info=np.asarray(info, self.dtype), **kw)

    def add_plane_normal_prior_edge(self, p, normal, info, **kw):
        return self._add("pprior", p=p, kind=0,
                         meas=np.asarray(normal, self.dtype),
                         info=np.asarray(info, self.dtype), **kw)

    def add_plane_distance_prior_edge(self, p, distance, info, **kw):
        return self._add("pprior", p=p, kind=1,
                         meas=np.asarray([distance, 0, 0], self.dtype),
                         info=np.asarray(info, self.dtype), **kw)

    def remove_edge(self, eid):
        self.edges = [e for e in self.edges if e["id"] != eid]

    def count_offchain(self):
        """Active se3 edges spanning vertices more than one index apart: what
        optimize_se3 sizes its Woodbury capacity by (its ``n_off``)."""
        return sum(e["type"] == "se3" and abs(e["i"] - e["j"]) > 1
                   for e in self.edges)

    # export ---------------------------------------------------------------
    @staticmethod
    def _cap(n, minimum=4):
        c = minimum
        while c < n:
            c *= 2
        return c

    def _pack(self, etype, fields, mdim, idim, extra=(), minimum=4, dtype=None):
        es = [e for e in self.edges if e["type"] == etype]
        ec = self._cap(len(es), minimum=minimum)
        dtype = dtype or self.dtype
        out = {f: np.zeros(ec, np.int64) for f in fields}
        out["meas"] = np.zeros((ec,) + mdim, dtype)
        out["info"] = np.zeros((ec,) + idim, dtype)
        out["level"] = np.zeros(ec, np.int64)
        out["kernel"] = np.zeros(ec, np.int64)
        out["delta"] = np.ones(ec, dtype)
        out["mask"] = np.zeros(ec, bool)
        for f in extra:
            out[f] = np.zeros(ec, np.int64)
        for k, e in enumerate(es):
            for f in fields + tuple(extra):
                out[f][k] = e[f]
            m = np.atleast_1d(np.asarray(e["meas"], dtype))
            out["meas"][k, : m.shape[0]] = m
            info = np.asarray(e["info"], dtype)
            if info.ndim == 0:
                # scalar -> isotropic information over the edge's natural dim
                info = info * np.eye(idim[0])
            d = info.shape[0]
            out["info"][k, :d, :d] = info
            out["level"][k] = e["level"]
            out["kernel"][k] = e["kernel"]
            out["delta"][k] = e["delta"]
            out["mask"][k] = True
        return out

    def to_arrays(self, dtype=None, v_capacity=None, e_capacity=None,
                  prior_capacity=None) -> SE3Graph:
        """Pack to padded tables on the builder's device. v_capacity /
        e_capacity / prior_capacity set capacity FLOORS (still doubled past
        them), so a long-running backend keeps one set of shapes across its
        cycles. Padded slots carry an identity quaternion or a [0,0,1,0]
        plane, so every residual stays finite on them."""
        dtype = dtype or self.dtype
        nv, npl, npt = len(self.poses), len(self.planes), len(self.points)
        vc = self._cap(nv, minimum=v_capacity or 4)
        pc, qc = self._cap(npl), self._cap(npt)
        ec = e_capacity or 4
        rc = prior_capacity or 4

        poses = np.zeros((vc, 7), dtype)
        poses[:, 3] = 1.0
        if nv:
            poses[:nv] = np.stack(self.poses)
        planes = np.zeros((pc, 4), dtype)
        planes[:, 2] = 1.0
        if npl:
            planes[:npl] = np.stack(self.planes)
        points = np.zeros((qc, 3), dtype)
        if npt:
            points[:npt] = np.stack(self.points)

        def msk(cap, n, flags):
            f = np.zeros(cap, bool)
            f[:n] = flags
            m = np.zeros(cap, bool)
            m[:n] = True
            return f, m

        def up(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

        def table(cls, etype, fields, mdim, idim, extra=(), minimum=4, pad=None):
            e = self._pack(etype, fields, mdim, idim, extra=extra,
                           minimum=minimum, dtype=dtype)
            if pad is not None:
                e["meas"][~e["mask"], pad] = 1.0
            return cls(*(up(e[f]) for f in cls._fields))

        fixed, vmask = msk(vc, nv, self.fixed)
        pfixed, pmask = msk(pc, npl, self.plane_fixed)
        qfixed, qmask = msk(qc, npt, self.point_fixed)
        return SE3Graph(
            up(poses), up(fixed), up(vmask),
            up(planes), up(pfixed), up(pmask),
            up(points), up(qfixed), up(qmask),
            # identity quaternion for padded measurement slots
            table(SE3Edges, "se3", ("i", "j"), (7,), (6, 6), minimum=ec, pad=3),
            table(SE3PriorXYEdges, "xy", ("i",), (2,), (2, 2), minimum=rc),
            table(SE3PriorXYZEdges, "xyz", ("i",), (3,), (3, 3), minimum=rc),
            table(SE3PriorVecEdges, "vec", ("i",), (6,), (3, 3), minimum=rc),
            table(SE3PriorQuatEdges, "quat", ("i",), (4,), (3, 3), minimum=rc,
                  pad=0),
            table(SE3PlaneEdges, "se3plane", ("i", "p"), (4,), (3, 3),
                  minimum=rc, pad=2),
            table(SE3PointEdges, "se3point", ("i", "q"), (3,), (3, 3)),
            table(PlanePlaneEdges, "pp", ("a", "b"), (4,), (4, 4),
                  extra=("kind",)),
            table(PlanePriorEdges, "pprior", ("p",), (3,), (3, 3),
                  extra=("kind",)),
        )

    def update_from(self, poses, planes=None, points=None):
        def host(x):
            return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)

        poses = host(poses)
        for v in range(len(self.poses)):
            self.poses[v] = poses[v].astype(self.dtype)
        if planes is not None:
            planes = host(planes)
            for p in range(len(self.planes)):
                self.planes[p] = planes[p].astype(self.dtype)
        if points is not None:
            points = host(points)
            for q in range(len(self.points)):
                self.points[q] = points[q].astype(self.dtype)
