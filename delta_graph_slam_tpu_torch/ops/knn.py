"""Brute-force neighbour search, tiled for bounded memory.

``nn_1`` is the exact 1-NN that the main path calls (fitness of every
odometry edge, the brute odometry status, brute GICP correspondences).
On a CUDA tensor it launches the Hopper kernel of ops/nn_kernel.py; on a
CPU tensor it runs ``nn_1_reference``, the plain chunked version that the
tests and the kernel check compare against. ``knn`` and ``radius_count``
are plain PyTorch on every device.
"""

import torch

from . import nn_kernel

_INF = float("inf")


def _dist2(query, tgt_chunk):
    # |q - t|^2 = |q|^2 - 2 q.t + |t|^2, in full float32 (no TF32)
    qq = (query * query).sum(-1, keepdim=True)
    tt = (tgt_chunk * tgt_chunk).sum(-1)
    qt = query @ tgt_chunk.T
    return torch.clamp(qq - 2.0 * qt + tt[None, :], min=0.0)


def _valid(mc, start, n, exclude_self, device):
    valid = mc[None, :]
    if exclude_self:
        tglobal = start + torch.arange(mc.shape[0], device=device)
        valid = valid & (tglobal[None, :] != torch.arange(n, device=device)[:, None])
    return valid


def nn_1(query, qmask, target, tmask, *, exclude_self=False, chunk=2048):
    """1-nearest-neighbour. Returns (dist2 (N,), idx (N,) int32).

    Invalid queries get dist2 = inf. ``exclude_self`` skips the target with
    the same index as the query (same-cloud searches).
    """
    if query.device.type == "cpu":
        return nn_1_reference(query, qmask, target, tmask,
                              exclude_self=exclude_self, chunk=chunk)
    return nn_kernel.nn_1_cuda(query, qmask, target, tmask,
                               exclude_self=exclude_self)


def nn_1_reference(query, qmask, target, tmask, *, exclude_self=False,
                   chunk=2048):
    """Plain PyTorch 1-NN over target chunks, keeping a running best.

    The first index wins among equal minima inside a chunk
    (``torch.min`` returns the first) and a later chunk must be strictly
    better, as in ops/knn.py:nn_1 of the JAX package.
    """
    n, device = query.shape[0], query.device
    best_d = torch.full((n,), _INF, dtype=query.dtype, device=device)
    best_i = torch.zeros((n,), dtype=torch.int32, device=device)
    for start in range(0, target.shape[0], chunk):
        tc = target[start:start + chunk]
        valid = _valid(tmask[start:start + chunk], start, n, exclude_self, device)
        d2 = torch.where(valid, _dist2(query, tc), _INF)
        cmin, carg = d2.min(dim=1)
        better = cmin < best_d
        best_d = torch.where(better, cmin, best_d)
        best_i = torch.where(better, (start + carg).to(torch.int32), best_i)
    return torch.where(qmask, best_d, _INF), best_i


def smallest_k(d, i, k):
    """k smallest of ``d`` along dim 1, ties to the lower position (the
    order lax.top_k gives on the negated distances)."""
    d, order = torch.sort(d, dim=1, stable=True)
    return d[:, :k], torch.gather(i, 1, order[:, :k])


def knn(query, qmask, target, tmask, k, *, exclude_self=False, chunk=1024):
    """k-nearest-neighbours. Returns (dists2 (N,k) ascending, idx (N,k)).

    Missing neighbours (fewer than k valid targets) get dist2 = inf.
    """
    n, device = query.shape[0], query.device
    best_d = torch.full((n, k), _INF, dtype=query.dtype, device=device)
    best_i = torch.zeros((n, k), dtype=torch.int32, device=device)
    for start in range(0, target.shape[0], chunk):
        tc = target[start:start + chunk]
        valid = _valid(tmask[start:start + chunk], start, n, exclude_self, device)
        d2 = torch.where(valid, _dist2(query, tc), _INF)
        tglobal = torch.arange(start, start + tc.shape[0], dtype=torch.int32,
                               device=device)
        alld = torch.cat([best_d, d2], dim=1)
        alli = torch.cat([best_i, tglobal[None, :].expand(n, -1)], dim=1)
        best_d, best_i = smallest_k(alld, alli, k)
    return torch.where(qmask[:, None], best_d, _INF), best_i


def radius_count(points, mask, radius, *, chunk=2048):
    """Number of *other* valid points within ``radius`` of each point."""
    n, device = points.shape[0], points.device
    count = torch.zeros((n,), dtype=torch.int32, device=device)
    for start in range(0, n, chunk):
        tc = points[start:start + chunk]
        valid = _valid(mask[start:start + chunk], start, n, True, device)
        inside = (_dist2(points, tc) <= radius * radius) & valid
        count += inside.sum(1).to(torch.int32)
    return torch.where(mask, count, 0)
