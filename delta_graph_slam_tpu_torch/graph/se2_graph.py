"""SE2 pose graph: vertex/edge tables and the host-side builder.

Vertex parameterization matches g2o::VertexSE2: raw (x, y, theta) with
additive updates and angle normalization. Edge types of the delta backend:
- EdgeSE2            odometry / loop closure / keyframe<->building /
                     building anti-overlap (levels 0/1/2)
- EdgeSE2PriorXY     GPS and building-alignment position priors
                     (error = t - m, edge_se2_priorxy.hpp:40-46)
- EdgeSE2PriorQuat   yaw priors (error = normalize(theta - theta_m),
                     edge_se2_priorquat.hpp:36-48)
"""

from typing import NamedTuple

import numpy as np
import torch

from ..geom.se2 import normalize_angle
from ..utils.device import DEFAULT_DEVICE, resolve_device
from .robust import kernel_id


class SE2Edges(NamedTuple):
    i: torch.Tensor       # (E,) int64 first vertex
    j: torch.Tensor       # (E,) int64 second vertex
    meas: torch.Tensor    # (E,3) measurement [x,y,theta] (Z: i->j)
    info: torch.Tensor    # (E,3,3)
    level: torch.Tensor   # (E,) int64
    kernel: torch.Tensor  # (E,) int64 robust kernel id
    delta: torch.Tensor   # (E,) kernel width
    mask: torch.Tensor    # (E,) bool


class SE2PriorXYEdges(NamedTuple):
    i: torch.Tensor       # (E,)
    meas: torch.Tensor    # (E,2)
    info: torch.Tensor    # (E,2,2)
    level: torch.Tensor
    kernel: torch.Tensor
    delta: torch.Tensor
    mask: torch.Tensor


class SE2PriorYawEdges(NamedTuple):
    i: torch.Tensor       # (E,)
    meas: torch.Tensor    # (E,)
    info: torch.Tensor    # (E,)
    level: torch.Tensor
    kernel: torch.Tensor
    delta: torch.Tensor
    mask: torch.Tensor


class SE2Graph(NamedTuple):
    poses: torch.Tensor   # (V,3)
    fixed: torch.Tensor   # (V,) bool
    vmask: torch.Tensor   # (V,) bool allocated
    edges: SE2Edges
    priors_xy: SE2PriorXYEdges
    priors_yaw: SE2PriorYawEdges


# ---------------------------------------------------------------- residuals

def se2_edge_error(pose_i, pose_j, meas):
    """g2o EdgeSE2: err = (Z^-1 * (Xi^-1 * Xj)).toVector(), batched (...,3)."""
    ci, si = torch.cos(pose_i[..., 2]), torch.sin(pose_i[..., 2])
    dx = pose_j[..., 0] - pose_i[..., 0]
    dy = pose_j[..., 1] - pose_i[..., 1]
    tx = ci * dx + si * dy
    ty = -si * dx + ci * dy
    cm, sm = torch.cos(meas[..., 2]), torch.sin(meas[..., 2])
    ex = cm * (tx - meas[..., 0]) + sm * (ty - meas[..., 1])
    ey = -sm * (tx - meas[..., 0]) + cm * (ty - meas[..., 1])
    eth = normalize_angle(pose_j[..., 2] - pose_i[..., 2] - meas[..., 2])
    return torch.stack([ex, ey, eth], -1)


def se2_prior_xy_error(pose_i, meas):
    return pose_i[..., :2] - meas


def se2_prior_yaw_error(pose_i, meas):
    return normalize_angle(pose_i[..., 2] - meas)[..., None]


# ------------------------------------------------------------------ builder

class SE2GraphBuilder:
    """Host-side mutable graph; ``to_arrays`` pads to fixed capacities and
    uploads to ``device``.

    Mirrors GraphSLAM's add_se2_node/add_se2_edge/add_robust_kernel helpers
    (graph_slam.cpp:112-336) with edge removal for the de-overlap loop.
    Edge ids are monotonic, so they stay unique after ``remove_edge``.
    """

    def __init__(self, dtype=np.float64, device=DEFAULT_DEVICE):
        self.dtype = dtype
        self.device = resolve_device(device)
        self.poses = []
        self.fixed = []
        self.edges = []       # dicts: id, type, i, j, meas, info, level, kernel, delta
        self._next_edge_id = 0
        # export cache: the backend packs the graph at least twice a cycle
        # (levels 0 and 1); only tables whose contents changed are repacked
        # and uploaded again
        self._dirty = {"v": True, "se2": True, "xy": True, "yaw": True}
        self._cache_key = None
        self._dev = {}

    def _mark(self, key):
        self._dirty[key] = True

    # ---- vertices
    def add_vertex(self, pose, fixed=False) -> int:
        self.poses.append(np.asarray(pose, self.dtype))
        self.fixed.append(bool(fixed))
        self._mark("v")
        return len(self.poses) - 1

    def set_fixed(self, vid, fixed=True):
        if self.fixed[vid] != bool(fixed):
            self.fixed[vid] = bool(fixed)
            self._mark("v")

    def set_all_fixed(self, fixed, only=None):
        for v in range(len(self.fixed)) if only is None else only:
            self.set_fixed(v, fixed)

    def set_pose(self, vid, pose):
        self.poses[vid] = np.asarray(pose, self.dtype)
        self._mark("v")

    @property
    def num_vertices(self):
        return len(self.poses)

    @property
    def num_edges(self):
        return len(self.edges)

    # ---- edges
    def _add_edge(self, etype, i, j, meas, info, level, kernel, delta):
        eid = self._next_edge_id
        self._next_edge_id += 1
        self.edges.append(dict(
            id=eid, type=etype, i=i, j=j,
            meas=np.asarray(meas, self.dtype), info=np.asarray(info, self.dtype),
            level=int(level), kernel=kernel_id(kernel), delta=float(delta),
        ))
        self._mark(etype)
        return eid

    def add_se2_edge(self, i, j, meas, info, level=0, kernel="NONE", delta=1.0):
        info = np.asarray(info, self.dtype)
        if info.ndim == 0:
            info = info * np.eye(3)
        return self._add_edge("se2", i, j, meas, info, level, kernel, delta)

    def add_prior_xy(self, i, meas, info, level=0, kernel="NONE", delta=1.0):
        info = np.asarray(info, self.dtype)
        if info.ndim == 0:
            info = info * np.eye(2)
        return self._add_edge("xy", i, None, meas, info, level, kernel, delta)

    def add_prior_yaw(self, i, meas, info, level=0, kernel="NONE", delta=1.0):
        return self._add_edge("yaw", i, None, np.asarray(meas, self.dtype),
                              np.asarray(info, self.dtype).reshape(()),
                              level, kernel, delta)

    def count_offchain(self, level=0):
        """Off-chain couplings at a level: binary se2 edges spanning
        non-adjacent, non-fixed vertices (loop closures, de-overlap pairs).
        Feeds optimize_se2's off_hint, which sizes the chain backend's
        Woodbury capacity."""
        n = 0
        for e in self.edges:
            if e["type"] != "se2" or e["level"] != level:
                continue
            i, j = e["i"], e["j"]
            if abs(i - j) > 1 and not self.fixed[i] and not self.fixed[j]:
                n += 1
        return n

    def spike_local_need(self, n_vertices_cap, level=0, p=16):
        """The largest per-segment endpoint-slot count of the locality-aware
        SPIKE solve (parallel/spike.py): off-chain edge endpoints binned
        into the p segments of the padded vertex table as
        _pack_endpoint_slots bins them (segment size ceil(N/p) rounded up
        to a power of two). Feeds optimize_se2's local_hint, so that the
        slot capacity fits the need and no edge is dropped."""
        m = -(-n_vertices_cap // p)
        if m & (m - 1):
            m = 1 << max(m - 1, 1).bit_length()
        counts = [0] * (p + 1)
        for e in self.edges:
            if e["type"] != "se2" or e["level"] != level:
                continue
            i, j = e["i"], e["j"]
            if abs(i - j) > 1 and not self.fixed[i] and not self.fixed[j]:
                counts[min(i // m, p)] += 1
                counts[min(j // m, p)] += 1
        return max(counts[:p])

    def remove_edge(self, eid):
        for e in self.edges:
            if e["id"] == eid:
                self._mark(e["type"])
        self.edges = [e for e in self.edges if e["id"] != eid]

    # ---- export
    @staticmethod
    def _cap(n, minimum=4):
        """Next capacity from {2^k, 3*2^(k-1)}: growth steps of 1.33x/1.5x
        instead of doubling."""
        c = minimum
        while True:
            if c >= n:
                return c
            c3 = (c // 2) * 3
            if c3 >= n:
                return c3
            c *= 2

    def to_arrays(self, v_capacity=None, e_capacity=None, dtype=None,
                  chain_first=False) -> SE2Graph:
        """Pack to padded tables on the builder's device.

        chain_first: lay the se2 edge table out as [vc-1 chain slots][rest].
        Slot k holds the odometry edge between vertices {k, k+1} in either
        stored orientation (the delta backend adds them reversed, new->prev,
        delta_graph_slam_nodelet.cpp:570-571), or an inactive placeholder;
        every other binary edge follows. The chain solver then assembles
        the block tridiagonal with shifts instead of scatters; for every
        other backend the layout changes nothing.
        """
        dtype = dtype or self.dtype
        nv = len(self.poses)
        vc = v_capacity or self._cap(nv)
        if vc < nv:
            raise ValueError(f"v_capacity {vc} < {nv} vertices")

        chain_parts = None
        if chain_first:
            slot_of = {}
            rest = []
            for e in self.edges:
                if e["type"] != "se2":
                    continue
                k = min(e["i"], e["j"])
                if abs(e["i"] - e["j"]) == 1 and k < vc - 1 and k not in slot_of:
                    slot_of[k] = e
                else:
                    rest.append(e)
            chain_parts = (slot_of, rest)

        def pack(etype, jdim, mdim, idim):
            es = [e for e in self.edges if e["type"] == etype]
            if chain_first and etype == "se2":
                slot_of, rest = chain_parts
                ec = (vc - 1) + max(self._cap(len(rest)), e_capacity or 0)
            else:
                ec = max(e_capacity or self._cap(len(es)), self._cap(len(es)))
            i = np.zeros(ec, np.int64)
            j = np.zeros(ec, np.int64)
            meas = np.zeros((ec,) + mdim, dtype)
            info = np.zeros((ec,) + idim, dtype)
            level = np.zeros(ec, np.int64)
            kern = np.zeros(ec, np.int64)
            delt = np.ones(ec, dtype)
            mask = np.zeros(ec, bool)
            if chain_first and etype == "se2":
                # row k <-> vertex pair (k, k+1), masked when absent (W = 0
                # downstream: an exact no-op)
                i[: vc - 1] = np.arange(vc - 1)
                j[: vc - 1] = np.arange(1, vc)
                es = [slot_of.get(k) for k in range(vc - 1)] + rest
                rows = [k for k, e in enumerate(es) if e is not None]
            else:
                rows = range(len(es))
            for k in rows:
                e = es[k]
                i[k] = e["i"]
                if jdim:
                    j[k] = e["j"]
                meas[k] = e["meas"]
                info[k] = e["info"]
                level[k] = e["level"]
                kern[k] = e["kernel"]
                delt[k] = e["delta"]
                mask[k] = True
            return i, j, meas, info, level, kern, delt, mask

        def up(*arrays):
            return [torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                    for a in arrays]

        # capacity growth or a dtype change rebuilds everything; otherwise
        # only tables whose contents changed since the last call are packed
        counts = tuple(sum(e["type"] == t for e in self.edges)
                       for t in ("se2", "xy", "yaw"))
        key = (vc, e_capacity, chain_first,
               self._cap(len(chain_parts[1])) if chain_first else None,
               tuple(max(e_capacity or 0, self._cap(c)) for c in counts),
               np.dtype(dtype).name)
        if key != self._cache_key:
            self._cache_key = key
            self._dev = {}
            for t in self._dirty:
                self._dirty[t] = True

        if self._dirty["v"] or "v" not in self._dev:
            poses = np.zeros((vc, 3), dtype)
            if nv:
                poses[:nv] = np.stack(self.poses)
            fixed = np.zeros(vc, bool)
            fixed[:nv] = self.fixed
            vmask = np.zeros(vc, bool)
            vmask[:nv] = True
            self._dev["v"] = up(poses, fixed, vmask)
            self._dirty["v"] = False
        if self._dirty["se2"] or "se2" not in self._dev:
            self._dev["se2"] = SE2Edges(*up(*pack("se2", True, (3,), (3, 3))))
            self._dirty["se2"] = False
        if self._dirty["xy"] or "xy" not in self._dev:
            i, _, *rest = pack("xy", False, (2,), (2, 2))
            self._dev["xy"] = SE2PriorXYEdges(*up(i, *rest))
            self._dirty["xy"] = False
        if self._dirty["yaw"] or "yaw" not in self._dev:
            i, _, *rest = pack("yaw", False, (), ())
            self._dev["yaw"] = SE2PriorYawEdges(*up(i, *rest))
            self._dirty["yaw"] = False

        poses, fixed, vmask = self._dev["v"]
        return SE2Graph(poses, fixed, vmask, self._dev["se2"],
                        self._dev["xy"], self._dev["yaw"])

    def update_poses(self, poses):
        """Pull optimized poses (V', 3), V' >= V, back into the builder."""
        if isinstance(poses, torch.Tensor):
            poses = poses.cpu().numpy()
        poses = np.asarray(poses)
        for v in range(len(self.poses)):
            self.poses[v] = poses[v].astype(self.dtype)
        self._mark("v")
