"""SE(2) rigid transforms as batched tensors.

Params layout ``(..., 3)`` = ``[x, y, theta]``, the pose-graph state of
g2o::VertexSE2. Every function broadcasts over leading dimensions and
keeps the input dtype and device.
"""

import torch


def normalize_angle(theta):
    """Wrap angle(s) to (-pi, pi], g2o::normalize_theta semantics."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def rot2(theta):
    """2x2 rotation matrices from angles: (...,) -> (...,2,2)."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], -1), torch.stack([s, c], -1)], -2)


def se2_matrix(params):
    """params (...,3) [x,y,theta] -> homogeneous (...,3,3)."""
    x, y, th = params[..., 0], params[..., 1], params[..., 2]
    c, s = torch.cos(th), torch.sin(th)
    z, o = torch.zeros_like(x), torch.ones_like(x)
    return torch.stack([torch.stack([c, -s, x], -1), torch.stack([s, c, y], -1),
                        torch.stack([z, z, o], -1)], -2)


def se2_params(matrix):
    """Homogeneous (...,3,3) -> params (...,3) [x,y,theta]."""
    th = torch.atan2(matrix[..., 1, 0], matrix[..., 0, 0])
    return torch.stack([matrix[..., 0, 2], matrix[..., 1, 2], th], -1)


def se2_compose(a, b):
    """a ∘ b (apply b first, then a). (...,3) x (...,3) -> (...,3)."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    return torch.stack([x, y, normalize_angle(a[..., 2] + b[..., 2])], -1)


def se2_inverse(p):
    """Inverse of SE2 params (...,3) -> (...,3)."""
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    x = -(c * p[..., 0] + s * p[..., 1])
    y = -(-s * p[..., 0] + c * p[..., 1])
    return torch.stack([x, y, -p[..., 2]], -1)


def se2_apply(p, pts):
    """Apply SE2 params p (...,3) to points pts (...,N,2) -> (...,N,2)."""
    return pts @ rot2(p[..., 2]).transpose(-1, -2) + p[..., None, :2]


def se2_exp(xi):
    """Exponential map: xi (...,3) = [vx, vy, omega] -> params (...,3),
    with a Taylor guard at omega ~ 0."""
    vx, vy, w = xi[..., 0], xi[..., 1], xi[..., 2]
    small = torch.abs(w) < 1e-6
    w_safe = torch.where(small, torch.ones_like(w), w)
    a = torch.where(small, 1.0 - w * w / 6.0, torch.sin(w_safe) / w_safe)
    b = torch.where(small, w / 2.0 - w**3 / 24.0,
                    (1.0 - torch.cos(w_safe)) / w_safe)
    return torch.stack([a * vx - b * vy, b * vx + a * vy, normalize_angle(w)], -1)


def se2_log(p):
    """Logarithm map: params (...,3) -> xi (...,3)."""
    x, y, th = p[..., 0], p[..., 1], normalize_angle(p[..., 2])
    small = torch.abs(th) < 1e-6
    half = torch.where(small, torch.ones_like(th), th) / 2.0
    # V(theta)^-1 = (half * cot(half)) I - half * skew
    cot_term = torch.where(small, 1.0 - th * th / 12.0,
                           half * torch.cos(half) / torch.sin(half))
    vx = cot_term * x + (th / 2.0) * y
    vy = -(th / 2.0) * x + cot_term * y
    return torch.stack([vx, vy, th], -1)
