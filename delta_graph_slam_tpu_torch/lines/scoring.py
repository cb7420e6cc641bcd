"""Line-to-line distances, coverage, and fitness scores.

Vectorizes the reference's scoring stack (line_based_scanmatcher.cpp):
- point_to_line_distance (segment-clamped)          :777-798
- line_to_line_distance (distance + coverage)       :811-903
- calc_fitness_score (length-weighted aggregation)  :905-955
- nearest_neighbor (per-line best target)           :957-983
- weight_global / weight_local                      (hpp:155-168)

Target lines may carry the same leading batch dimensions as the source.
"""

from typing import NamedTuple

import torch

from .features import _norm, _unit, lines_intersection

_INF = float("inf")


class FitnessScore(NamedTuple):
    real_avg_distance: torch.Tensor
    avg_distance: torch.Tensor
    coverage: torch.Tensor
    coverage_percentage: torch.Tensor


def point_to_segment_distance(p, a, b):
    """Distance from point(s) to segment(s) [a,b] with endpoint clamping."""
    d = b - a
    len2 = (d * d).sum(-1)
    t = ((p - a) * d).sum(-1) / torch.clamp(len2, min=1e-12)
    t = torch.clamp(t, 0.0, 1.0)
    proj = a + t[..., None] * d
    return _norm(p - proj)


def line_to_line_distance(src_a, src_b, trg_a, trg_b):
    """The reference's distance+coverage metric, batched over any shape.

    Returns FitnessScore per pair. Semantics (cpp:811-903): the first two
    of four ordered candidate events (srcA/srcB projected inside trg;
    trgA/trgB perpendicular feet inside src) define the covered interval;
    avg_distance is the mean of their two distances, coverage the interval
    length; fewer than two events -> avg_distance inf, coverage 0.
    """
    d = _unit(trg_b - trg_a)

    def on_seg(p, a, b):
        dot1 = ((p - a) * (b - a)).sum(-1)
        dot2 = ((p - b) * (a - b)).sum(-1)
        return (dot1 >= 0) & (dot2 >= 0)

    # events 1,2: src endpoints projected onto trg line
    pts = []
    for sp in (src_a, src_b):
        proj = trg_a + d * ((sp - trg_a) * d).sum(-1, keepdim=True)
        pts.append((sp, _norm(sp - proj), on_seg(proj, trg_a, trg_b)))

    # events 3,4: perpendiculars through trg endpoints intersected with src
    dperp = torch.stack([d[..., 1], -d[..., 0]], -1)
    for tp in (trg_a, trg_b):
        inter, iok = lines_intersection(src_a, src_b, tp, tp + dperp)
        pts.append((inter, _norm(tp - inter), on_seg(inter, src_a, src_b) & iok))

    # broadcast all four events to the common pair shape before stacking
    shape = torch.broadcast_shapes(*(p[1].shape for p in pts))
    valid = torch.stack([p[2].expand(shape) for p in pts], -1)
    dists = torch.stack([p[1].expand(shape) for p in pts], -1)
    points = torch.stack([p[0].expand(shape + (2,)) for p in pts], -2)  # (...,4,2)
    # running count of valid events, summed out by hand: a cumsum over this
    # 4-wide axis runs one slow scan per pair on CUDA (~5 ms a chunk)
    v = valid.to(torch.int32)
    c1 = v[..., 0] + v[..., 1]
    c2 = c1 + v[..., 2]
    cum = torch.stack([v[..., 0], c1, c2, c2 + v[..., 3]], -1)
    first = valid & (cum == 1)
    second = valid & (cum == 2)
    has2 = second.any(-1)

    def pick(flag, arr):
        return torch.where(flag[..., None], arr, 0.0).sum(-2)

    p1 = pick(first, points)
    p2 = pick(second, points)
    d1 = torch.where(first, dists, 0.0).sum(-1)
    d2 = torch.where(second, dists, 0.0).sum(-1)

    avg = torch.where(has2, (d1 + d2) / 2.0, _INF)
    cov = torch.where(has2, _norm(p2 - p1), 0.0)
    covp = cov / torch.clamp(_norm(src_b - src_a), min=1e-12)

    real = 0.5 * (point_to_segment_distance(src_a, trg_a, trg_b)
                  + point_to_segment_distance(src_b, trg_a, trg_b))
    return FitnessScore(real, avg, cov, covp)


def pairwise_scores(src, trg):
    """All (..., Ls, Lt) line pair FitnessScores. src/trg: LineSegments."""
    return line_to_line_distance(src.a[..., :, None, :], src.b[..., :, None, :],
                                 trg.a[..., None, :, :], trg.b[..., None, :, :])


def nearest_neighbor(src, trg):
    """Per-source-line targets sorted by real_distance ascending.

    Returns (order (..., Ls, Lt) target indices, scores FitnessScore with
    (..., Ls, Lt) fields sorted accordingly, valid (..., Ls, Lt)). Invalid
    targets sort last; equal distances keep target order (a stable sort,
    as the reference's, cpp:957-983).
    """
    fs = pairwise_scores(src, trg)
    pvalid = src.mask[..., :, None] & trg.mask[..., None, :]
    key = torch.where(pvalid, fs.real_avg_distance, _INF)
    order = torch.argsort(key, dim=-1, stable=True)
    fs_sorted = FitnessScore(*(torch.take_along_dim(f, order, dim=-1) for f in fs))
    return order, fs_sorted, torch.take_along_dim(pvalid, order, dim=-1)


def fitness_core(sa, sb, smask, trg, is_local, max_range=_INF):
    """calc_fitness_score over arbitrary leading batch dims.

    sa/sb: (..., Ls, 2) source endpoints; smask (..., Ls); trg LineSegments
    whose (..., Lt) fields broadcast against the source's batch. Returns
    FitnessScore with (...) fields. Per source line the nearest target is
    the one of minimum real distance, the first among equals
    (cpp:957-983); the gate uses avg_distance for local and real distance
    for global (:924-930).
    """
    fs = line_to_line_distance(sa[..., :, None, :], sb[..., :, None, :],
                               trg.a[..., None, :, :], trg.b[..., None, :, :])
    pvalid = (smask[..., :, None] & trg.mask[..., None, :]).expand(
        fs.real_avg_distance.shape)
    key = torch.where(pvalid, fs.real_avg_distance, _INF)
    nn = torch.argmin(key, dim=-1, keepdim=True)

    def take(x):
        return torch.take_along_dim(x, nn, dim=-1)[..., 0]

    nn_real = take(fs.real_avg_distance)
    nn_dist = take(fs.avg_distance)
    nn_cov = take(fs.coverage)
    has_nn = take(pvalid)

    lens = torch.where(smask, _norm(sb - sa), 0.0)
    metric = nn_dist if is_local else nn_real
    in_range = has_nn & (metric < max_range) & smask

    real_num = torch.where(in_range, nn_real * lens, 0.0).sum(-1)
    real_den = torch.where(in_range, lens, 0.0).sum(-1)
    dist_num = torch.where(in_range, nn_dist * nn_cov, 0.0).sum(-1)
    cov_len = torch.where(in_range, nn_cov, 0.0).sum(-1)
    total_len = lens.sum(-1)

    real_avg = torch.where(real_den > 0, real_num / torch.clamp(real_den, min=1e-12), _INF)
    avg = torch.where(cov_len > 0, dist_num / torch.clamp(cov_len, min=1e-12), _INF)
    covp = torch.where(total_len > 0,
                       cov_len / torch.clamp(total_len, min=1e-12) * 100.0, 0.0)
    return FitnessScore(real_avg, avg, cov_len, covp)


def calc_fitness_score(src, trg, is_local, max_range=_INF):
    """Aggregate score over all source lines (cpp:905-955)."""
    return fitness_core(src.a, src.b, src.mask, trg, is_local, max_range)


def weight_score(avg_distance, coverage_percentage, translation,
                 avg_distance_weight=0.6, coverage_weight=1.0,
                 transform_weight=0.2, max_score_distance=5.0,
                 max_score_translation=5.0):
    """weight_global / weight_local (hpp:155-168); higher is better."""
    return (
        -avg_distance_weight
        * (torch.clamp(avg_distance, max=max_score_distance) / max_score_distance)
        * 100.0
        + coverage_weight * coverage_percentage
        - transform_weight
        * (torch.clamp(translation, max=max_score_translation) / max_score_translation)
        * 100.0
    )
