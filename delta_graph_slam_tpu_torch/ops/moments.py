"""Dense masked neighbourhood moments: the exact radius search as products.

Counterpart of the JAX package's ops/moments.py, which is XLA code there
(no Pallas kernel), so this is plain PyTorch. It serves the 'dense'
neighbour methods: pcl::RadiusOutlierRemoval neighbour counts,
pcl::NormalEstimation covariances (prefiltering_nodelet.cpp:77-98,
:217-247) and the GICP covariance models. For each Morton-ordered query
chunk Qc:

    W  = (|q - x|^2 <= r^2) & support_mask          # (Ns, Cq)
    Mt = F^T @ W                                    # (10, Cq)

with F = [1, xc, upper6(xc xc^T)] the support moment features, giving the
neighbour count, mean and covariance of every query in two products.

Exactness: counts/means/covs are the exact radius-neighbourhood statistics
(PCL RadiusSearch semantics), with no cell-capacity truncation. float32
cancellation in the second moments is controlled by centring each chunk's
features at the chunk's query centroid; Morton ordering bounds the chunk
span, so |x - c| stays of the order of the chunk extent for every pair that
survives W.

What keeps it equal to the reference: both products run as true float32
(utils/device.py:strict_fp32_matmul, no TF32; the reference asks for
HIGHEST / HIGH precision); ``d2`` uses the reference's expansion
|qc|^2 + |xc|^2 - 2 xc.qc on chunk-centred coordinates, whose rounding
decides pairs at the boundary; ``morton_keys`` divides by a device tensor
(a true division, as by the reference's traced resolution; a CPU scalar
would be a reciprocal product on CUDA); the Morton argsort is stable, as
jnp.argsort is, since ties (points of one Morton cell) decide the chunk
centroids. The chunks run in a Python loop: at chunk 4096 against a
32768-slot support the masked W is 512 MB in float32.

The float32 error of the result scales with the terms about the chunk
centre: |qc|^2 + |xc|^2 for the distance test, the neighbourhood's second
moment about the centre for the covariance (a few float32 ulps of each).
"""

from typing import NamedTuple

import torch

from ..utils.device import strict_fp32_matmul
from .cloud import MaskedCloud

_INT32_MAX = torch.iinfo(torch.int32).max
# (row, column) -> moment-feature index of the symmetric second moments
_SECOND = [4, 5, 6, 5, 7, 8, 6, 8, 9]


def _part1by2(v):
    """Spread the low 10 bits of v so there are two zero bits between each."""
    v = v & 0x3FF
    v = (v | (v << 16)) & 0x30000FF
    v = (v | (v << 8)) & 0x300F00F
    v = (v | (v << 4)) & 0x30C30C3
    v = (v | (v << 2)) & 0x9249249
    return v


def morton_keys(points, mask, resolution=None):
    """30-bit Morton (Z-order) key per point (int32); invalid points sort last.

    resolution=None picks bbox/1023 along the largest axis (at least 1 mm)
    so the 10-bit grid covers the masked cloud.
    """
    pts = points
    big = torch.finfo(pts.dtype).max
    lo = torch.where(mask[:, None], pts, big).amin(0)
    if resolution is None:
        hi = torch.where(mask[:, None], pts, -big).amax(0)
        # a product with the float32 reciprocal, as XLA compiles the
        # reference's division by the constant 1023 inside jit
        resolution = torch.clamp((hi - lo).amax() * (1.0 / 1023.0), min=1e-3)
    else:
        resolution = torch.as_tensor(resolution, dtype=pts.dtype, device=pts.device)
    # clamped before the cast: an out-of-range float has no int32 value
    cell = torch.clamp(torch.floor((pts - lo[None, :]) / resolution), 0, 1023)
    cell = cell.to(torch.int32)
    key = ((_part1by2(cell[:, 0]) << 2) | (_part1by2(cell[:, 1]) << 1)
           | _part1by2(cell[:, 2]))
    return torch.where(mask, key, _INT32_MAX)


class RadiusMoments(NamedTuple):
    count: torch.Tensor  # (N,) int32 - neighbours within radius, self included
    mean: torch.Tensor   # (N,3) neighbourhood centroid
    cov: torch.Tensor    # (N,3,3) population covariance of the neighbourhood
    valid: torch.Tensor  # (N,) query was masked & count >= 1


def _moment_features(xc, smask):
    """(Ns, 10) support features [1, x, y, z, x^2, xy, xz, y^2, yz, z^2]
    (centred)."""
    x, y, z = xc[:, 0], xc[:, 1], xc[:, 2]
    return torch.stack([smask.to(xc.dtype), x, y, z, x * x, x * y, x * z,
                        y * y, y * z, z * z], 1)


def _chunk_moments(q, qm, rr2, sup, smask):
    """(count (C,), mean (C,3), cov (C,3,3)) of one query chunk."""
    # chunk centre: the masked query centroid (Morton order keeps it near
    # every query, so the centred coordinates of true neighbours stay small
    # and the raw-moment -> central-moment subtraction does not cancel)
    wq = qm.to(q.dtype)
    c = (q * wq[:, None]).sum(0) / torch.clamp(wq.sum(), min=1.0)
    qc = q - c[None, :]
    xc = sup - c[None, :]
    d2 = ((qc * qc).sum(1)[None, :] + (xc * xc).sum(1)[:, None]
          - 2.0 * (xc @ qc.T))                                   # (Ns, C)
    w = ((d2 <= rr2[None, :]) & smask[:, None]).to(q.dtype)
    del d2
    mt = _moment_features(xc, smask).T @ w                       # (10, C)
    cnt = mt[0]
    safe = torch.clamp(cnt, min=1.0)
    mean_c = mt[1:4] / safe[None, :]
    raw2 = mt[_SECOND].reshape(3, 3, -1) / safe[None, None, :]
    cov = raw2 - mean_c[:, None, :] * mean_c[None, :, :]
    return cnt, (mean_c + c[:, None]).T, cov.permute(2, 0, 1)


def _radius_moments_sorted(qs, qmask, sup, smask, r2, chunk):
    """Moments for Morton-ordered queries ``qs`` against support ``sup``,
    chunk by chunk. r2: (Nq,) squared radii. Returns (count int32, mean,
    cov) in the sorted query order."""
    parts = []
    with strict_fp32_matmul():
        for c0 in range(0, qs.shape[0], chunk):
            s = slice(c0, c0 + chunk)
            parts.append(_chunk_moments(qs[s], qmask[s], r2[s], sup, smask))
    cnt, mean, cov = (torch.cat(p) for p in zip(*parts))
    return cnt.to(torch.int32), mean, cov


def radius_moments(
    query_cloud: MaskedCloud,
    support_cloud: MaskedCloud,
    radius,
    *,
    chunk: int = 4096,
    sort_queries: bool = True,
) -> RadiusMoments:
    """Exact radius-neighbourhood count/mean/covariance for every query.

    radius may be a scalar or a per-query array (adaptive search radii for
    range-dependent point density). Results come back in the original query
    order. Queries are padded to a multiple of ``chunk`` (zero r^2, false
    mask) and Morton-sorted internally for float32-safe chunk centring.
    """
    q, qm = query_cloud.points, query_cloud.mask
    nq = q.shape[0]
    pad = (-nq) % chunk
    r2 = torch.broadcast_to(
        torch.as_tensor(radius, dtype=q.dtype, device=q.device) ** 2, (nq,))
    if pad:
        q = torch.cat([q, q.new_zeros((pad, 3))])
        qm = torch.cat([qm, qm.new_zeros((pad,))])
        r2 = torch.cat([r2, r2.new_zeros((pad,))])
    sup, smask = support_cloud.points, support_cloud.mask
    if sort_queries:
        order = torch.argsort(morton_keys(q, qm), stable=True)
        cnt, mean, cov = _radius_moments_sorted(q[order], qm[order], sup, smask,
                                                r2[order], chunk)
        inv = torch.empty_like(order)
        inv[order] = torch.arange(len(order), device=order.device)
        cnt, mean, cov = cnt[inv], mean[inv], cov[inv]
    else:
        cnt, mean, cov = _radius_moments_sorted(q, qm, sup, smask, r2, chunk)
    cnt, mean, cov = cnt[:nq], mean[:nq], cov[:nq]
    return RadiusMoments(cnt, mean, cov, query_cloud.mask & (cnt >= 1))
