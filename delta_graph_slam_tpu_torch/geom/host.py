"""Numpy SE2/SE3 operations for host-side pose bookkeeping.

A copy of delta_graph_slam_tpu/geom/host.py: the backend chains many tiny
pose compositions per frame, which stay on the host in float64.
"""

import numpy as np


def normalize_angle_np(theta):
    return np.arctan2(np.sin(theta), np.cos(theta))


def se2_compose_np(a, b):
    a = np.asarray(a, float)
    b = np.asarray(b, float)
    ca, sa = np.cos(a[..., 2]), np.sin(a[..., 2])
    return np.stack(
        [
            a[..., 0] + ca * b[..., 0] - sa * b[..., 1],
            a[..., 1] + sa * b[..., 0] + ca * b[..., 1],
            normalize_angle_np(a[..., 2] + b[..., 2]),
        ],
        axis=-1,
    )


def se2_inverse_np(p):
    p = np.asarray(p, float)
    c, s = np.cos(p[..., 2]), np.sin(p[..., 2])
    return np.stack(
        [
            -(c * p[..., 0] + s * p[..., 1]),
            -(-s * p[..., 0] + c * p[..., 1]),
            -p[..., 2],
        ],
        axis=-1,
    )


def se2_matrix_np(p):
    p = np.asarray(p, float)
    c, s = np.cos(p[2]), np.sin(p[2])
    return np.array([[c, -s, p[0]], [s, c, p[1]], [0.0, 0.0, 1.0]])


def transform_2d_to_3d_np(p):
    p = np.asarray(p, float)
    c, s = np.cos(p[2]), np.sin(p[2])
    T = np.eye(4)
    T[0, 0], T[0, 1], T[0, 3] = c, -s, p[0]
    T[1, 0], T[1, 1], T[1, 3] = s, c, p[1]
    return T


def quat_to_rot_np(q):
    """Unit quaternions (...,4) [w,x,y,z] -> rotation matrices (...,3,3)."""
    q = np.asarray(q, float)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3))
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def _euler_xyz_np(R):
    """Eigen-range xyz extraction (matches geom.se3.euler_xyz_from_rot)."""
    r00, r01, r02 = R[0, 0], R[0, 1], R[0, 2]
    r12, r22 = R[1, 2], R[2, 2]
    a = np.arctan2(-r12, r22)
    cb = np.hypot(r00, r01)
    if a < 0:
        a = np.arctan2(r12, -r22)
        b = np.arctan2(r02, -cb)
        c = np.arctan2(r01, -r00)
    else:
        b = np.arctan2(r02, cb)
        c = np.arctan2(-r01, r00)
    return np.array([a, b, c])


def yaw_from_rot_np(R):
    """normalize_euler_angs min-norm trick (ros_utils.cpp:95-131)."""
    e = _euler_xyz_np(np.asarray(R, float))
    shifted = e - np.pi * np.where(e >= 0, 1.0, -1.0)
    if np.linalg.norm(shifted) < np.linalg.norm(e):
        e = shifted
    return e[2]


def transform_3d_to_2d_np(T):
    T = np.asarray(T, float)
    return np.array([T[0, 3], T[1, 3], yaw_from_rot_np(T[:3, :3])])
