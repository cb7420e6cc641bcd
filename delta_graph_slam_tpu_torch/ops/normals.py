"""kNN surface normals with an analytic 3x3 symmetric eigensolver.

Replaces pcl::NormalEstimation as used by the prefiltering 2-D branch
(k=10 normals, keep |n_z| < 0.2; prefiltering_nodelet.cpp:217-247).
The eigensolver is closed-form (no iteration, no LAPACK), vectorized
across every point.
"""

import math

import numpy as np
import torch

from .cloud import MaskedCloud
from .knn import knn
from .voxel import build_voxel_hash
from .voxel_knn import neighbourhood_cov, voxel_knn

# the 27-cell neighbourhood of the voxel-bounded searches
OFFSETS_27 = np.asarray(
    [[i, j, l] for i in (-1, 0, 1) for j in (-1, 0, 1) for l in (-1, 0, 1)],
    np.int32,
)


def det3x3(A):
    """Determinant of (...,3,3) by cofactors (closed form, no LU)."""
    return (
        A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
        - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
        + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0])
    )


def eigenvalues3x3(A):
    """Trigonometric closed form: (l_min, l_mid, l_max) of symmetric A."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    q = A.diagonal(dim1=-2, dim2=-1).sum(-1) / 3.0
    Aq = A - q[..., None, None] * eye
    p2 = (Aq * Aq).sum(dim=(-2, -1)) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    B = Aq / p[..., None, None]
    r = torch.clamp(det3x3(B) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    l_max = q + 2.0 * p * torch.cos(phi)
    l_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    l_mid = 3.0 * q - l_max - l_min
    return l_min, l_mid, l_max


def kernel_column(A, lam1, lam2):
    """Largest column of (A - lam1 I)(A - lam2 I) and its norm (...,1):
    it spans the eigenspace of the third eigenvalue."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    M = (A - lam1[..., None, None] * eye) @ (A - lam2[..., None, None] * eye)
    col = torch.linalg.vector_norm(M, dim=-2).argmax(-1)  # first on ties
    v = torch.gather(M, -1, col[..., None, None].expand(*M.shape[:-1], 1))[..., 0]
    return v, torch.linalg.vector_norm(v, dim=-1, keepdim=True)


def smallest_eigvec_3x3(A):
    """Unit eigenvector of the smallest eigenvalue of symmetric A (...,3,3).

    Falls back to +z for isotropic neighbourhoods.
    """
    _, lam_mid, lam_max = eigenvalues3x3(A)
    # columns of (A - lam_max I)(A - lam_mid I) span the lam_min eigenspace
    v, vn = kernel_column(A, lam_max, lam_mid)
    fallback = torch.zeros_like(v)
    fallback[..., 2] = 1.0
    ok = vn[..., 0] > 1e-12 * torch.clamp(torch.abs(lam_max), min=1.0)
    return torch.where(ok[..., None], v / torch.clamp(vn, min=1e-30), fallback)


def estimate_normals(cloud: MaskedCloud, k: int = 10, viewpoint=(0.0, 0.0, 0.0),
                     *, chunk=1024, method="brute", voxel_resolution=0.75,
                     voxel_window=16):
    """Per-point unit normals from the k nearest neighbours (self included),
    oriented toward the viewpoint. Returns (normals (N,3), valid (N,)).

    method='voxel' bounds the kNN candidates to a spatial hash (27 cells x
    window points); 'brute' is the exact tiled kNN search. The reference's
    'dense' radius path (ops/moments.py) is not ported yet.
    """
    pts, mask = cloud.points, cloud.mask
    if method == "voxel":
        vh = build_voxel_hash(cloud, voxel_resolution, pts.shape[0],
                              dense_index=True, with_stats=False)
        # query with the ORIGINAL point order so the mask lines up
        d2, idx, ok = voxel_knn(vh, pts, mask, k, OFFSETS_27, window=voxel_window)
        nb_valid = ok & torch.isfinite(d2)
        nb = vh.sorted_points[idx]
    elif method == "brute":
        d2, idx = knn(pts, mask, pts, mask, k=k, exclude_self=False, chunk=chunk)
        nb_valid = torch.isfinite(d2)
        nb = pts[idx.to(torch.int64)]
    else:
        raise NotImplementedError(f"neighbour method {method!r} is not ported")
    n = smallest_eigvec_3x3(neighbourhood_cov(nb, nb_valid))
    vp = torch.tensor(viewpoint, dtype=pts.dtype, device=pts.device)
    flip = ((vp - pts) * n).sum(-1) < 0.0
    n = torch.where(flip[:, None], -n, n)
    valid = mask & (nb_valid.sum(1) >= 3)
    return n, valid


def normal_filter(
    cloud: MaskedCloud,
    thresh: float = 0.2,
    k: int = 10,
    viewpoint=(0.0, 0.0, 0.0),
    keep_vertical_surfaces: bool = True,
    *,
    chunk=1024,
    method="brute",
) -> MaskedCloud:
    """Keep points by normal verticality.

    keep_vertical_surfaces=True : |n_z| <  thresh (walls; prefiltering:217-247)
    keep_vertical_surfaces=False: |n_z| >  thresh (floors; floor_detection:211-238)
    """
    n, valid = estimate_normals(cloud, k=k, viewpoint=viewpoint, chunk=chunk,
                                method=method)
    nz = torch.abs(n[:, 2])
    keep = (nz < thresh) if keep_vertical_surfaces else (nz > thresh)
    return MaskedCloud(cloud.points, cloud.mask & valid & keep)
