"""Many-hypothesis RANSAC plane and line estimators.

Instead of PCL's sequential sample loop with early exit
(pcl::RandomSampleConsensus in floor detection,
floor_detection_nodelet.cpp:138-141, and line segmentation,
line_based_scanmatcher.cpp:345-358), a fixed batch of hypotheses is drawn,
scored all at once, and the best one taken (first index among equal vote
counts). The inliers of each line are pruned to their largest cluster by
1-D gap clustering on the line coordinate (DIVERGENCES.md §14);
``euclidean_cluster_mask`` is the general euclidean clustering, which no
ported path calls.

The samples come in as an argument: ``ransac_plane`` takes
``(n_hypotheses, 3)`` uniforms in [0, 1) and ``ransac_line``
``(max_lines, n_hypotheses, 2)``, so any random stream drives them; the
stages' default is the reference's threefry stream (utils/prng.py).
Everything stays on the cloud's device:
the ``max_lines`` iterations are masked and read nothing back to the host.
"""

import math
from typing import NamedTuple

import torch

from ..utils.device import strict_fp32_matmul
from .cloud import MaskedCloud
from .knn import _dist2


class LineSegments(NamedTuple):
    """Fixed-capacity batch of 2-D line segments with per-line stats.

    Mirrors the reference LineFeature (PointA/PointB/mean_error/std_sigma/
    max_error/min_error, line_based_scanmatcher.hpp). Fields may carry
    leading batch dimensions.
    """

    a: torch.Tensor           # (..., L, 2)
    b: torch.Tensor           # (..., L, 2)
    mean_error: torch.Tensor  # (..., L)
    std_sigma: torch.Tensor   # (..., L)
    max_error: torch.Tensor   # (..., L)
    min_error: torch.Tensor   # (..., L)
    mask: torch.Tensor        # (..., L) bool

    @property
    def capacity(self):
        return self.a.shape[-2]

    def lengths(self):
        return torch.linalg.norm(self.b - self.a, dim=-1)

    def directions(self):
        d = self.b - self.a
        return d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-12)


def _sample_indices(u, count):
    """Random valid indices into a compacted cloud, from uniforms ``u``;
    the product is taken in ``u``'s own dtype, as the reference does."""
    return (u * torch.clamp(count, min=1).to(u.dtype)).to(torch.int64)


class RansacResult(NamedTuple):
    coeffs: torch.Tensor      # (4,) plane [a,b,c,d], unit normal
    inliers: torch.Tensor     # (N,) bool
    n_inliers: torch.Tensor   # () int64
    ok: torch.Tensor          # () bool


def ransac_plane(cloud: MaskedCloud, uniforms, dist_thresh: float = 0.1,
                 min_inliers: int = 512) -> RansacResult:
    """Plane RANSAC on a masked cloud from uniforms ``(n_hypotheses, 3)``.
    coeffs = unit-normal [a,b,c,d].

    The (N, H) point-to-plane product decides votes at ``dist_thresh``, so
    it must run as a true float32 product: the floor stage calls this under
    ``utils/device.py:strict_fp32_matmul``."""
    pts, mask = cloud.points, cloud.mask
    count = mask.sum()
    order = torch.argsort((~mask).to(torch.uint8), stable=True)  # valid first
    idx = order[_sample_indices(uniforms, count)]
    p0, p1, p2 = pts[idx[:, 0]], pts[idx[:, 1]], pts[idx[:, 2]]
    n = torch.linalg.cross(p1 - p0, p2 - p0)
    nn = torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    degenerate = nn[:, 0] < 1e-9
    n = n / torch.clamp(nn, min=1e-12)
    d = -(n * p0).sum(-1)                              # (H,)
    dist = torch.abs(pts @ n.T + d[None, :])           # (N, H)
    votes = ((dist < dist_thresh) & mask[:, None]).sum(0)
    votes = torch.where(degenerate, -1, votes)
    best = torch.argmax(votes)                         # the first maximum
    coeffs = torch.cat([n[best], d[best][None]])
    inl = mask & (torch.abs(pts @ coeffs[:3] + coeffs[3]) < dist_thresh)
    n_inl = inl.sum()
    return RansacResult(coeffs, inl, n_inl, n_inl >= min_inliers)


def refine_plane(points, inliers, coeffs):
    """Least-squares plane refit over inliers (smallest eigenvector of the
    centered covariance), oriented as the input model."""
    from .normals import smallest_eigvec_3x3

    w = inliers.to(points.dtype)[:, None]
    cnt = torch.clamp(w.sum(), min=1.0)
    mean = (points * w).sum(0) / cnt
    c = (points - mean) * w
    n = smallest_eigvec_3x3(c.T @ c / cnt)
    n = torch.where(torch.dot(n, coeffs[:3]) < 0, -n, n)
    return torch.cat([n, -torch.dot(n, mean)[None]])


def _point_line_dist2_2d(pts, a, dirn):
    """Squared 2-D distance from points (N,2+) to the infinite line a + t*dir."""
    rel = pts[:, :2] - a[None, :2]
    t = rel @ dirn[:2]
    proj = t[:, None] * dirn[None, :2]
    return ((rel - proj) ** 2).sum(-1)


def ransac_line_single(pts, mask, u, dist_thresh):
    """One best line hypothesis on the masked 2-D cloud from uniforms
    ``u`` (n_hypotheses, 2).

    Returns (a (2,), dir unit (2,), inliers (N,) bool). Valid points need
    not be a contiguous prefix: samples are drawn through a valid-first
    permutation (the iterative extractor punches holes in the mask).
    """
    count = mask.sum()
    order = torch.argsort((~mask).to(torch.uint8), stable=True)  # valid first
    idx = order[_sample_indices(u, count)]
    p0 = pts[idx[:, 0], :2]
    p1 = pts[idx[:, 1], :2]
    d = p1 - p0
    dn = torch.linalg.norm(d, dim=-1, keepdim=True)
    degenerate = dn[:, 0] < 1e-9
    d = d / torch.clamp(dn, min=1e-12)
    # distance of every point to every hypothesis line: |cross(d, p - p0)|
    rel_x = pts[:, None, 0] - p0[None, :, 0]
    rel_y = pts[:, None, 1] - p0[None, :, 1]
    cross = rel_x * d[None, :, 1] - rel_y * d[None, :, 0]
    votes = ((torch.abs(cross) < dist_thresh) & mask[:, None]).sum(0)
    votes = torch.where(degenerate, -1, votes)
    best = torch.argmax(votes)
    a, dirn = p0[best], d[best]
    inl = mask & (_point_line_dist2_2d(pts, a, dirn) < dist_thresh * dist_thresh)
    return a, dirn, inl



def euclidean_cluster_mask(points, mask, tolerance, *, rounds=None, chunk=1024):
    """Label connected components (distance <= tolerance) and return the mask
    of the LARGEST cluster plus per-point labels (int32; n for invalid
    points). Replaces pcl::EuclideanClusterExtraction.

    Min-label propagation with pointer jumping: converges in O(log N) rounds
    for any cluster shape (including 2 cm-spaced point chains). Each round
    takes every point's smallest neighbour label over target chunks, then
    jumps twice (label <- min(label, label[label])). The cluster sizes are an
    integer sum; among equal sizes the first label wins, as in the reference.
    """
    n = points.shape[0]
    if rounds is None:
        rounds = max(1, math.ceil(math.log2(max(n, 2))) + 2)
    tol2 = tolerance * tolerance
    labels = torch.where(mask, torch.arange(n, device=points.device), n)

    def neighbour_min(labels):
        lab = labels
        for c0 in range(0, n, chunk):
            d2 = _dist2(points, points[c0:c0 + chunk])
            valid = mask[None, c0:c0 + chunk] & (d2 <= tol2)
            cand = torch.where(valid, labels[None, c0:c0 + chunk], n)
            lab = torch.minimum(lab, cand.amin(1))
        return torch.where(mask, lab, n)

    with strict_fp32_matmul():
        for _ in range(rounds):
            labels = neighbour_min(labels)
            for _ in range(2):
                safe = torch.clamp(labels, 0, n - 1)
                labels = torch.where(mask, torch.minimum(labels, labels[safe]), n)
    counts = torch.zeros(n + 1, dtype=torch.int64, device=points.device)
    counts.index_add_(0, torch.clamp(labels, 0, n), mask.to(torch.int64))
    winner = torch.argmax(counts[:-1])
    return (labels == winner) & mask, labels.to(torch.int32)


def line_gap_cluster_mask(t_proj, mask, tolerance):
    """Largest connected cluster of points that lie (near) a common line,
    clustered by their 1-D projection onto it (DIVERGENCES.md §14).

    Points sorted by projection start a new run where the gap to the
    previous one exceeds ``tolerance``; the run with the most points wins,
    the first one among equal counts. Counts are integer sums, so the
    result is the same on every device.
    """
    n = t_proj.shape[0]
    key = torch.where(mask, t_proj, torch.inf)
    order = torch.argsort(key, stable=True)          # valid first, by t
    ts = key[order]
    valid = mask[order]
    gap = ts - torch.cat([ts[:1], ts[:-1]])
    # new run when the gap exceeds tolerance (the first element starts run
    # 0); the invalid tail (inf - inf = nan) never wins
    new_run = torch.cat([torch.zeros(1, dtype=torch.bool, device=mask.device),
                         (gap > tolerance)[1:]])
    run = torch.cumsum(new_run.to(torch.int64), 0)
    run = torch.where(valid, run, n)
    counts = torch.zeros(n + 1, dtype=torch.int64, device=mask.device)
    counts.scatter_add_(0, run, valid.to(torch.int64))
    winner = torch.argmax(counts[:-1])
    keep_sorted = (run == winner) & valid
    keep = torch.zeros_like(mask)
    keep[order] = keep_sorted
    return keep & mask


def ransac_line(
    cloud: MaskedCloud,
    uniforms: torch.Tensor,
    dist_thresh: float = 0.1,
    min_cluster_size: int = 25,
    max_cluster_size: int = 25000,
    cluster_tolerance: float = 1.0,
    merror_threshold: float = 150.0,
    length_threshold: float = 1.0,
) -> LineSegments:
    """Iterative line extraction (line_based_scanmatcher.cpp:336-457).

    ``uniforms`` (max_lines, n_hypotheses, 2) holds each iteration's
    samples. Loop: fit the best line by RANSAC -> keep only the largest
    cluster of its inliers -> compute segment endpoints/statistics ->
    remove the inliers -> accept if mean_error < merror_threshold and
    length > length_threshold. Runs ``max_lines`` fixed iterations with
    masking (iterations after the cloud is exhausted are no-ops).
    """
    pts2 = cloud.points[:, :2]
    mask = cloud.mask
    outs = []
    for u in uniforms:
        enough = mask.sum() >= min_cluster_size
        a, dirn, inl = ransac_line_single(pts2, mask, u, dist_thresh)
        t_proj = (pts2 - a[None, :]) @ dirn
        cluster = line_gap_cluster_mask(t_proj, inl, cluster_tolerance)
        csize = cluster.sum()
        cluster = cluster & (csize <= max_cluster_size)
        accept_cluster = (csize >= min_cluster_size) & enough

        # per-point distances to the infinite line (errors)
        err = torch.sqrt(_point_line_dist2_2d(pts2, a, dirn))
        w = cluster.to(pts2.dtype)
        cnt = torch.clamp(csize.to(pts2.dtype), min=1.0)
        mean_err = (err * w).sum() / cnt
        sigma = torch.sqrt((w * (err - mean_err) ** 2).sum() / cnt)
        max_err = torch.where(cluster, err, -torch.inf).max()
        min_err = torch.where(cluster, err, torch.inf).min()

        # endpoints: extreme projections of cluster points onto the line
        t_lo = torch.where(cluster, t_proj, torch.inf).min()
        t_hi = torch.where(cluster, t_proj, -torch.inf).max()
        pa = a + t_lo * dirn
        pb = a + t_hi * dirn
        length = t_hi - t_lo

        good = accept_cluster & (mean_err < merror_threshold) & (length > length_threshold)
        # remove the cluster; when it was too small the reference still
        # removes those inliers
        remove = cluster & enough
        mask = mask & ~remove
        outs.append((pa, pb, mean_err, torch.where(good, sigma, 0.0),
                     torch.where(good, max_err, 0.0), torch.where(good, min_err, 0.0), good))
    pa, pb, me, sg, mx, mn, ok = (torch.stack(x) for x in zip(*outs))
    return LineSegments(
        a=torch.where(ok[:, None], pa, 0.0),
        b=torch.where(ok[:, None], pb, 0.0),
        mean_error=torch.where(ok, me, 0.0),
        std_sigma=sg, max_error=mx, min_error=mn, mask=ok,
    )
