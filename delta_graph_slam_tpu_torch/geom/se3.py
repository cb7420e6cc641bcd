"""SE(3) transforms and quaternions on batched tensors.

Counterparts of the JAX package's geom/se3.py: quaternion <-> rotation,
homogeneous assembly and inverse, and the exponential and logarithm maps.
Quaternion layout is ``[w, x, y, z]`` throughout. Every function is written
without in-place writes and without branches on tensor values, so it can
be differentiated in forward mode (the tests hold the SE3 solver's
closed-form Jacobians against such derivatives).
"""

import torch


def quat_to_rot(q):
    """Quaternion(s) (...,4) [w,x,y,z] -> rotation matrix (...,3,3)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], -1),
    ]
    return torch.stack(rows, dim=-2)


def rot_to_quat(R):
    """Rotation matrix (...,3,3) -> quaternion (...,4) [w,x,y,z], w >= 0.

    Branch-free Shepperd construction: four candidates, the one with the
    largest pivot among [trace, m00, m11, m22] is taken (the first maximum
    on a tie)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def half_sqrt(v):
        return torch.sqrt(torch.clamp(1.0 + v, min=0.0)) / 2.0

    qw0 = half_sqrt(tr)
    d0 = torch.clamp(4.0 * qw0, min=1e-12)
    q0 = torch.stack([qw0, (m21 - m12) / d0, (m02 - m20) / d0, (m10 - m01) / d0], -1)

    qx1 = half_sqrt(m00 - m11 - m22)
    d1 = torch.clamp(4.0 * qx1, min=1e-12)
    q1 = torch.stack([(m21 - m12) / d1, qx1, (m01 + m10) / d1, (m02 + m20) / d1], -1)

    qy2 = half_sqrt(-m00 + m11 - m22)
    d2 = torch.clamp(4.0 * qy2, min=1e-12)
    q2 = torch.stack([(m02 - m20) / d2, (m01 + m10) / d2, qy2, (m12 + m21) / d2], -1)

    qz3 = half_sqrt(-m00 - m11 + m22)
    d3 = torch.clamp(4.0 * qz3, min=1e-12)
    q3 = torch.stack([(m10 - m01) / d3, (m02 + m20) / d3, (m12 + m21) / d3, qz3], -1)

    idx = torch.argmax(torch.stack([tr, m00, m11, m22], -1), dim=-1)
    qs = torch.stack([q0, q1, q2, q3], dim=-2)                 # (...,4cands,4)
    # a gather, not a weighted sum: a candidate whose root sits at zero has
    # an infinite derivative, which must not reach the one that is taken
    pick = idx[..., None, None].expand(idx.shape + (1, 4))
    q = torch.take_along_dim(qs, pick, dim=-2)[..., 0, :]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def se3_matrix(R=None, t=None, quat=None):
    """Homogeneous (...,4,4) from a rotation (matrix or quat) and a
    translation."""
    if quat is not None:
        R = quat_to_rot(quat)
    if t is None:
        t = R.new_zeros(R.shape[:-2] + (3,))
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], dim=-1)
    bottom = torch.cat([R.new_zeros(batch + (1, 3)), R.new_ones(batch + (1, 1))],
                       dim=-1)
    return torch.cat([top, bottom], dim=-2)


def se3_inverse(T):
    """Inverse of homogeneous (...,4,4)."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    ti = -(Rt @ T[..., :3, 3:4])[..., 0]
    return se3_matrix(Rt, ti)


def _skew(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack(
        [
            torch.stack([z, -w[..., 2], w[..., 1]], -1),
            torch.stack([w[..., 2], z, -w[..., 0]], -1),
            torch.stack([-w[..., 1], w[..., 0], z], -1),
        ],
        dim=-2,
    )


def so3_exp(w):
    """Rodrigues: rotation vector (...,3) -> rotation matrix (...,3,3).

    The guards are on th^2 and the root is taken of a guarded value only, so
    a forward-mode derivative at w = 0 stays finite (the pose-graph
    Jacobians are taken at exactly zero)."""
    th2 = (w * w).sum(-1)
    small = th2 < 1e-16
    th_safe = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th_safe) / th_safe)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th_safe)) / th_safe**2)
    K = _skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + A[..., None, None] * K + B[..., None, None] * (K @ K)


def se3_exp(xi):
    """xi (...,6) = [v, w] -> homogeneous (...,4,4). Derivative-safe at 0."""
    v, w = xi[..., :3], xi[..., 3:]
    th2 = (w * w).sum(-1)
    small = th2 < 1e-16
    th_safe = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th_safe)) / th_safe**2)
    C = torch.where(small, 1.0 / 6.0 - th2 / 120.0,
                    (th_safe - torch.sin(th_safe)) / th_safe**3)
    K = _skew(w)
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(K.shape)
    V = eye + B[..., None, None] * K + C[..., None, None] * (K @ K)
    return se3_matrix(so3_exp(w), (V @ v[..., None])[..., 0])


def so3_log(R):
    """Rotation matrix (...,3,3) -> rotation vector (...,3)."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    th = torch.arccos(torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0))
    small = th < 1e-6
    th_safe = torch.where(small, torch.ones_like(th), th)
    factor = torch.where(small, 0.5 + th * th / 12.0,
                         th_safe / (2.0 * torch.sin(th_safe)))
    vee = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                       R[..., 0, 2] - R[..., 2, 0],
                       R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    # near th = pi the vee form degrades; adequate for incremental updates
    return factor[..., None] * vee


def se3_log(T):
    """Homogeneous (...,4,4) -> xi (...,6) = [v, w]."""
    w = so3_log(T[..., :3, :3])
    th = torch.linalg.vector_norm(w, dim=-1)
    small = th < 1e-6
    th_safe = torch.where(small, torch.ones_like(th), th)
    half = th_safe / 2.0
    cot_term = torch.where(small, 1.0 - th * th / 12.0,
                           half * torch.cos(half) / torch.sin(half))
    K = _skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    th2_safe = torch.where(small, torch.ones_like(th), th * th)
    Vinv = eye - 0.5 * K + ((1.0 - cot_term) / th2_safe)[..., None, None] * (K @ K)
    v = (Vinv @ T[..., :3, 3:4])[..., 0]
    return torch.cat([v, w], dim=-1)
