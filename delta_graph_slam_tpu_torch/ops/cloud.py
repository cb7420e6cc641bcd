"""Fixed-capacity masked point clouds and elementwise filters.

A cloud is ``(points (N,3) float32, mask (N,) bool)`` at a fixed capacity,
as in the JAX package: filters flip mask bits, ``compact`` re-packs the
valid points to the front, and outputs compare slot by slot with the
reference.
"""

from typing import NamedTuple

import numpy as np
import torch


class MaskedCloud(NamedTuple):
    points: torch.Tensor  # (N, 3) float32
    mask: torch.Tensor    # (N,) bool

    @property
    def capacity(self):
        return self.points.shape[0]

    def count(self):
        return self.mask.sum()


def make_cloud(points, mask=None, capacity=None, device="cpu") -> MaskedCloud:
    """Build a MaskedCloud from a (possibly ragged) array, padded on the host
    to ``capacity`` and uploaded once."""
    pts = np.array(points, np.float32)  # a writable copy for torch
    n = pts.shape[0]
    if capacity is None:
        capacity = n
    mask_np = np.ones((n,), bool) if mask is None else np.array(mask, bool)
    if capacity != n:
        if capacity < n:
            raise ValueError(f"capacity {capacity} < {n} points")
        pts = np.pad(pts, ((0, capacity - n), (0, 0)))
        mask_np = np.pad(mask_np, (0, capacity - n))
    return MaskedCloud(
        torch.from_numpy(pts).to(device),
        torch.from_numpy(mask_np).to(device),
    )


def compact(cloud: MaskedCloud) -> MaskedCloud:
    """Stable re-pack of valid points to the front (invalid slots zeroed)."""
    order = torch.sort((~cloud.mask).to(torch.uint8), stable=True).indices
    pts = cloud.points[order]
    mask = cloud.mask[order]
    return MaskedCloud(torch.where(mask[:, None], pts, 0.0), mask)


def transform_cloud(cloud: MaskedCloud, T) -> MaskedCloud:
    """Apply a homogeneous (4,4) transform."""
    T = torch.as_tensor(T, dtype=cloud.points.dtype, device=cloud.points.device)
    pts = cloud.points @ T[:3, :3].T + T[:3, 3]
    return MaskedCloud(torch.where(cloud.mask[:, None], pts, 0.0), cloud.mask)


def distance_filter(cloud: MaskedCloud, near: float, far: float) -> MaskedCloud:
    """Radial gate: keep near < |p| < far (prefiltering_nodelet.cpp:275-291)."""
    d = torch.sqrt((cloud.points * cloud.points).sum(-1))
    keep = cloud.mask & (d > near) & (d < far)
    return MaskedCloud(cloud.points, keep)


def height_filter(cloud: MaskedCloud, z_min: float) -> MaskedCloud:
    """Keep points strictly above the lidar height
    (prefiltering_nodelet.cpp:192-209)."""
    keep = cloud.mask & (cloud.points[:, 2] > z_min)
    return MaskedCloud(cloud.points, keep)


def flatten_z(cloud: MaskedCloud) -> MaskedCloud:
    """Project to the z=0 plane (prefiltering_nodelet.cpp:166-184)."""
    pts = cloud.points.clone()
    pts[:, 2] = 0.0
    return MaskedCloud(pts, cloud.mask)


def plane_clip(cloud: MaskedCloud, plane, negative: bool = False) -> MaskedCloud:
    """Keep points on one side of plane (a,b,c,d): sign of p.n + d.

    Mirrors pcl::PlaneClipper3D usage in floor detection
    (floor_detection_nodelet.cpp:189-204).
    """
    plane = torch.as_tensor(plane, dtype=cloud.points.dtype,
                            device=cloud.points.device)
    dist = cloud.points @ plane[:3] + plane[3]
    keep = (dist < 0.0) if negative else (dist > 0.0)
    return MaskedCloud(cloud.points, cloud.mask & keep)


def deskew(cloud: MaskedCloud, angular_velocity, scan_period: float = 0.1) -> MaskedCloud:
    """IMU-based rotational deskew (prefiltering_nodelet.cpp:293-354).

    Point i (acquired at t_i = scan_period * i / N, N the capacity) is
    rotated by the inverse of the small-angle quaternion
    delta_q = [1, t_i/2 * (-w)] (the reference negates the angular velocity
    then applies delta_q.inverse()), normalized.
    """
    pts = cloud.points
    w = -torch.as_tensor(angular_velocity, dtype=pts.dtype, device=pts.device)
    n = cloud.capacity
    t = scan_period * torch.arange(n, dtype=pts.dtype, device=pts.device) / n
    half = 0.5 * t[:, None] * w          # (N,3) vector parts; scalar part 1
    norm = torch.sqrt(1.0 + (half * half).sum(-1, keepdim=True))
    qw = 1.0 / norm
    qv = -half / norm
    # Rodrigues via the quaternion: p' = p + 2 qw (qv x p) + 2 qv x (qv x p)
    c1 = torch.linalg.cross(qv, pts, dim=-1)
    c2 = torch.linalg.cross(qv, c1, dim=-1)
    out = pts + 2.0 * qw * c1 + 2.0 * c2
    return MaskedCloud(torch.where(cloud.mask[:, None], out, 0.0), cloud.mask)
