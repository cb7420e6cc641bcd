"""Batched 3x3 symmetric eigendecomposition and GICP covariance models.

fast_gicp computes per-point covariances from the k nearest neighbours and
regularizes them to "plane" form (eigenvalues -> [1e-3, 1, 1]); PCL NDT
floors small voxel-covariance eigenvalues relative to the largest. Both
are closed-form here, vectorized across every point or voxel.
"""

import torch

from ..ops.knn import knn
from ..ops.normals import eigenvalues3x3, kernel_column
from ..ops.voxel_knn import neighbourhood_cov


def eigh3x3(A):
    """Eigen-decomposition of symmetric A (...,3,3).

    Returns (eigvals (...,3) ascending, eigvecs (...,3,3) column-major:
    eigvecs[...,:,i] is the unit eigenvector of eigvals[...,i]).
    """
    l_min, l_mid, l_max = eigenvalues3x3(A)
    vals = torch.stack([l_min, l_mid, l_max], dim=-1)
    v_min, n_min = kernel_column(A, l_max, l_mid)
    v_max, n_max = kernel_column(A, l_min, l_mid)
    scale = torch.clamp(torch.abs(l_max), min=1.0)
    ok_min = n_min[..., 0] > 1e-12 * scale
    ok_max = n_max[..., 0] > 1e-12 * scale
    ex = torch.zeros_like(v_min)
    ex[..., 0] = 1.0
    ez = torch.zeros_like(v_min)
    ez[..., 2] = 1.0
    v_min = torch.where(ok_min[..., None], v_min / torch.clamp(n_min, min=1e-30), ez)
    v_max = torch.where(ok_max[..., None], v_max / torch.clamp(n_max, min=1e-30), ex)
    # re-orthogonalize v_max against v_min (degenerate safety), then cross
    v_max = v_max - (v_max * v_min).sum(-1, keepdim=True) * v_min
    v_max = v_max / torch.clamp(
        torch.linalg.vector_norm(v_max, dim=-1, keepdim=True), min=1e-30)
    v_mid = torch.linalg.cross(v_max, v_min, dim=-1)
    return vals, torch.stack([v_min, v_mid, v_max], dim=-1)


def regularize_covariances(covs, mode="plane", floor_ratio=1e-2):
    """Rebuild covariances with modified eigenvalues.

    mode='plane'  : eigenvalues -> [1e-3, 1, 1]  (fast_gicp RegularizationMethod::PLANE)
    mode='floor'  : eigenvalues -> max(lam, floor_ratio * lam_max)  (PCL NDT style)
    mode='none'   : unchanged
    """
    if mode == "none":
        return covs
    vals, vecs = eigh3x3(covs)
    if mode == "plane":
        new_vals = torch.tensor([1e-3, 1.0, 1.0], dtype=covs.dtype,
                                device=covs.device).expand(vals.shape)
    elif mode == "floor":
        lam_max = torch.clamp(vals[..., 2:3], min=1e-12)
        new_vals = torch.maximum(vals, floor_ratio * lam_max)
    else:
        raise ValueError(mode)
    return torch.einsum("...ij,...j,...kj->...ik", vecs, new_vals, vecs)


def knn_covariances(points, mask, k=20, *, mode="plane", chunk=1024):
    """Per-point neighbourhood covariances (self included), regularized.

    fast_gicp semantics: covariance of the k nearest neighbours
    (correspondence_randomness), then 'plane' regularization.
    Returns (covs (N,3,3), valid (N,)).
    """
    d2, idx = knn(points, mask, points, mask, k=k, exclude_self=False, chunk=chunk)
    nb_valid = torch.isfinite(d2)
    cov = regularize_covariances(
        neighbourhood_cov(points[idx.to(torch.int64)], nb_valid), mode=mode)
    return cov, mask & (nb_valid.sum(1) >= 3)
