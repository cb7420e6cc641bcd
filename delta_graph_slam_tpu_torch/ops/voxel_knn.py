"""Voxel-hash bounded neighbour search.

Each query gathers a fixed window of points from neighbouring cells of
the hash's cell-sorted point array, then reduces over those candidates.
Exact for neighbours within one cell radius; ``ops/knn.py`` stays the
exact brute-force path.
"""

import torch

from .knn import smallest_k
from .voxel import VoxelHash, batch_take, voxel_lookup

_INF = float("inf")


def _candidates(vh: VoxelHash, query, qmask, offsets, window):
    """Candidate indices (N, M, W) into vh.sorted_points, their validity
    and squared distances to the queries (with a leading B for a batch of
    problems against a stacked hash, as voxel_lookup)."""
    batched = query.ndim == 3
    slots, hit = voxel_lookup(vh, query, qmask, offsets=offsets)  # (N,M)
    starts = batch_take(vh.starts, slots, batched)
    counts = batch_take(vh.counts, slots, batched).to(torch.int32)
    w = torch.arange(window, dtype=torch.int32, device=query.device)
    cand = starts[..., None] + w
    cvalid = hit[..., None] & (w < counts[..., None])
    cand = torch.clamp(cand, 0, vh.sorted_points.shape[-2] - 1).to(torch.int64)
    diff = (batch_take(vh.sorted_points, cand, batched)
            - query[..., :, None, None, :])
    d2 = (diff * diff).sum(-1)
    return cand, cvalid, d2


def voxel_nn(vh: VoxelHash, query, qmask, offsets, window=8, max_d2=_INF):
    """1-NN among windowed candidates. Returns (d2 (N,), idx (N,) into
    vh.sorted_points, valid (N,))."""
    d2, idx, valid = voxel_knn(vh, query, qmask, 1, offsets, window, max_d2)
    return d2[..., 0], idx[..., 0], valid[..., 0]


def voxel_knn(vh: VoxelHash, query, qmask, k, offsets, window=8, max_d2=_INF):
    """k-NN among windowed candidates.

    Returns (d2 (N,k) ascending, idx (N,k) indices into vh.sorted_points,
    valid (N,k)). Missing candidates -> d2 = inf. Among equal distances the
    earlier candidate wins, as with argmin and lax.top_k in the reference.
    k = 1 also takes a batch of problems (query (B,N,3)), as voxel_lookup.
    """
    cand, cvalid, d2 = _candidates(vh, query, qmask, offsets, window)
    lead = tuple(cand.shape[:-2])
    d2 = torch.where(cvalid & (d2 <= max_d2), d2, _INF).reshape(lead + (-1,))
    candf = cand.reshape(lead + (-1,))
    if k == 1:
        best = torch.argmin(d2, dim=-1, keepdim=True)  # first among equal minima
        bd = torch.gather(d2, -1, best)
        bi = torch.gather(candf, -1, best)
    else:
        bd, bi = smallest_k(d2, candf, k)
    return bd, bi, torch.isfinite(bd) & qmask[..., None]


def voxel_radius_count(vh: VoxelHash, query, qmask, radius, offsets,
                       window=8, exclude_self=True):
    """Count neighbours within ``radius`` among windowed voxel candidates.

    Undercounts when a cell holds more than ``window`` points. Queries are
    assumed to BE hash points when exclude_self (one self-match
    subtracted)."""
    _, cvalid, d2 = _candidates(vh, query, qmask, offsets, window)
    inside = cvalid & (d2 <= radius * radius)
    n = inside.sum(dim=(1, 2)).to(torch.int32)
    if exclude_self:
        n = n - 1
    return torch.where(qmask, torch.clamp(n, min=0), 0)


def voxel_knn_covariances(vh: VoxelHash, k, offsets, window=8, mode="plane"):
    """Per-point neighbourhood covariances over the hash's own points.

    fast_gicp's correspondence_randomness-kNN covariance, with candidates
    bounded to neighbouring voxels. Operates on vh.sorted_points (the order
    the registration engine uses). Returns (covs (N,3,3), valid (N,)).
    """
    from .covariance_shim import regularize

    pts = vh.sorted_points
    msk = vh.sorted_valid
    _, idx, valid = voxel_knn(vh, pts, msk, k, offsets, window)
    cov = regularize(neighbourhood_cov(pts[idx], valid), mode)
    ok = msk & (valid.sum(1) >= 3)
    return cov, ok


def neighbourhood_cov(nb, valid):
    """Population covariance of the valid rows of each (k,3) neighbourhood."""
    w = valid.to(nb.dtype)
    cnt = torch.clamp(w.sum(1), min=1.0)
    mean = (nb * w[..., None]).sum(1) / cnt[:, None]
    centered = (nb - mean[:, None, :]) * w[..., None]
    return torch.einsum("nka,nkb->nab", centered, centered) / cnt[:, None, None]
