"""SE(3) exponential maps for the registration update.

Counterparts of _skew, so3_exp and se3_exp in the JAX package's
geom/se3.py, on batched tensors.
"""

import torch


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
    """Rodrigues: rotation vector (...,3) -> rotation matrix (...,3,3)."""
    th2 = (w * w).sum(-1)
    small = th2 < 1e-16
    th_safe = torch.sqrt(torch.where(small, torch.ones_like(th2), th2))
    A = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th_safe) / th_safe)
    B = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th_safe)) / th_safe**2)
    K = _skew(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + A[..., None, None] * K + B[..., None, None] * (K @ K)


def se3_exp(xi):
    """xi (...,6) = [v, w] -> homogeneous (...,4,4)."""
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
    T = torch.zeros(xi.shape[:-1] + (4, 4), dtype=xi.dtype, device=xi.device)
    T[..., :3, :3] = so3_exp(w)
    T[..., :3, 3] = (V @ v[..., None])[..., 0]
    T[..., 3, 3] = 1.0
    return T
