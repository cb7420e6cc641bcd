"""align_global / align_local / align_overlapped_buildings.

The reference's greedy best-so-far candidate loops
(line_based_scanmatcher.cpp:109-297, :29-107) adopt a candidate only on
strict score improvement, so scoring every candidate at once and taking
the first argmax gives the same winner (DIVERGENCES.md §6). Candidates are
scored in chunks (a Python loop over the candidate axis), so the
(candidates x Ls x Lt) tensors stay a few hundred MB at full capacity.

Phase 2 ("use best transform found so far") composes exactly one
line-to-NN refinement on top of the phase-1 winner: top-1 for the global
alignment, top-3 for the local one (the reference's `i<3 || i<n` bound
reads out of bounds with fewer than 3 neighbours, DIVERGENCES.md §4).

Every alignment is batch-general: leading dimensions of the line sets are
pairs of the batched calls (the JAX package's vmap). A transform that no
phase adopts is an exact identity, which the backend tests for.
"""

import dataclasses
import math
from typing import NamedTuple

import numpy as np
import torch

from ..geom.se2 import se2_compose, se2_inverse
from ..ops.cloud import MaskedCloud
from ..ops.ransac import LineSegments, ransac_line
from .features import (
    EdgeFeatures, _rotate, _unit, align_edges, align_lines_pair, apply_rt, edge_extraction,
    gather_lines, make_lines, rot2, transform_lines,
)
from .merge import merge_lines
from .overlap import are_buildings_overlapped
from .scoring import FitnessScore, fitness_core, pairwise_scores, weight_score

_INF = float("inf")


@dataclasses.dataclass(frozen=True)
class LineScanmatcherConfig:
    # line fitting (hpp:80-92 defaults; delta launch overrides)
    min_cluster_size: int = 25
    max_cluster_size: int = 25000
    cluster_tolerance: float = 1.0
    sac_distance_threshold: float = 0.1
    max_iterations: int = 500
    merror_threshold: float = 150.0
    line_length_threshold: float = 1.0
    # global fitness weights (hpp:93-99)
    g_avg_distance_weight: float = 0.6
    g_coverage_weight: float = 1.0
    g_transform_weight: float = 0.2
    g_max_score_distance: float = 5.0
    g_max_score_translation: float = 5.0
    # local fitness weights
    l_avg_distance_weight: float = 0.6
    l_coverage_weight: float = 1.0
    l_transform_weight: float = 0.2
    l_max_score_distance: float = 5.0
    l_max_score_translation: float = 5.0
    # capacities
    max_lines: int = 24
    max_target_lines: int = 64
    edge_capacity: int = 128
    target_edge_capacity: int = 192
    # edge capacity of the building side of align_local / align_overlapped
    # (building polygons carry <= ~16 outline lines)
    building_edge_capacity: int = 32
    # phase-1 candidates are compacted (stable, valid-first) to this many
    # slots before scoring; overflow drops later-index candidates only
    # (DIVERGENCES.md §15)
    g_candidate_capacity: int = 4096
    l_candidate_capacity: int = 1024
    score_chunk: int = 256
    n_hypotheses: int = 256
    cloud_chunk: int = 1024


class BestFitAlignment(NamedTuple):
    transformation: torch.Tensor      # (..., 4, 4)
    not_aligned_lines: LineSegments
    aligned_lines: LineSegments
    fitness: FitnessScore             # (...) fields
    is_edge_aligned: torch.Tensor     # (...) bool
    score: torch.Tensor               # (...) weight score of the result


def _se3_from_rt(R2, t2):
    T = torch.zeros(R2.shape[:-2] + (4, 4), dtype=R2.dtype, device=R2.device)
    T[..., :2, :2] = R2
    T[..., :2, 3] = t2
    T[..., 2, 2] = 1.0
    T[..., 3, 3] = 1.0
    return T


def _matmul2(A, B):
    """A @ B for (..., 2, 2) blocks, elementwise: an identity A returns B
    exactly."""
    return (A[..., :, :, None] * B[..., None, :, :]).sum(-2)


def _take(x, idx, trailing):
    """x[..., idx, <trailing dims>] for idx (..., 1) from an argmax."""
    idx = idx.reshape(idx.shape + (1,) * trailing)
    return torch.take_along_dim(x, idx, dim=-1 - trailing).squeeze(-1 - trailing)


def _compact_candidates(R, t, valid, K):
    """Stable valid-first compaction of a candidate transform set to K
    slots. Stability keeps the candidate order among the valid ones, so
    the first-argmax tie-breaking downstream matches the uncompacted (and
    the reference's sequential greedy) order. When more than K candidates
    are valid the overflow (later-index) ones drop."""
    C = valid.shape[-1]
    if K <= 0 or K >= C:
        return R, t, valid
    order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)[..., :K]
    return (torch.take_along_dim(R, order[..., None, None], dim=-3),
            torch.take_along_dim(t, order[..., None], dim=-2),
            torch.take_along_dim(valid, order, dim=-1))


def _chunked_scores(R, t, valid, src: LineSegments, trg: LineSegments,
                    is_local, max_range, weight_fn, chunk):
    """Weight scores (..., C) of candidate transforms R (..., C, 2, 2),
    t (..., C, 2) applied to src; -inf where invalid. ``chunk`` candidates
    are scored at a time."""
    smask = src.mask[..., None, :]
    trg_c = trg._replace(a=trg.a[..., None, :, :], b=trg.b[..., None, :, :],
                         mask=trg.mask[..., None, :])
    sa0, sb0 = src.a[..., None, :, :], src.b[..., None, :, :]
    out = []
    for c0 in range(0, valid.shape[-1], chunk):
        Rc = R[..., c0:c0 + chunk, :, :]
        tc = t[..., c0:c0 + chunk, :]
        fs = fitness_core(apply_rt(Rc, tc, sa0), apply_rt(Rc, tc, sb0), smask,
                          trg_c, is_local, max_range)
        metric = fs.avg_distance if is_local else fs.real_avg_distance
        s = weight_fn(metric, fs.coverage_percentage, torch.linalg.norm(tc, dim=-1))
        out.append(torch.where(valid[..., c0:c0 + chunk], s, -_INF))
    return torch.cat(out, -1)


def _edge_candidates(src_edges: EdgeFeatures, trg_edges: EdgeFeatures):
    """align_edges over every (source edge, target edge) pair, source-major:
    (R (..., Es*Et, 2, 2), t (..., Es*Et, 2), valid (..., Es*Et))."""
    Es, Et = src_edges.mask.shape[-1], trg_edges.mask.shape[-1]
    dev = src_edges.mask.device
    si = torch.arange(Es, device=dev).repeat_interleave(Et)
    ti = torch.arange(Et, device=dev).repeat(Es)
    R, t = align_edges(
        gather_lines(src_edges.corner, si), gather_lines(src_edges.a, si),
        gather_lines(src_edges.b, si), gather_lines(trg_edges.corner, ti),
        gather_lines(trg_edges.a, ti), gather_lines(trg_edges.b, ti),
    )
    return R, t, src_edges.mask[..., si] & trg_edges.mask[..., ti]


def _weight_fn(cfg: LineScanmatcherConfig, is_local):
    p = "l_" if is_local else "g_"
    kw = {k: getattr(cfg, p + k) for k in (
        "avg_distance_weight", "coverage_weight", "transform_weight",
        "max_score_distance", "max_score_translation")}
    return lambda d, c, t: weight_score(d, c, t, **kw)


def _align(cfg: LineScanmatcherConfig, is_local, src: LineSegments,
           trg: LineSegments, src_edges: EdgeFeatures, trg_edges: EdgeFeatures,
           constrain_angle, max_range) -> BestFitAlignment:
    """The two-phase alignment of _make_align_fn (JAX lines/align.py:152-268)."""
    max_distance = 2.5 if is_local else 2.0
    weight_fn = _weight_fn(cfg, is_local)
    cos_max = math.cos(math.pi / 9.0)
    # the global path aligns one keyframe at a time, so a 4x wider chunk;
    # the local path runs a batch of pairs and keeps the narrow chunk
    chunk = cfg.score_chunk if is_local else cfg.score_chunk * 4
    dtype, dev = src.a.dtype, src.a.device
    eye = torch.eye(2, dtype=dtype, device=dev)

    fs0 = fitness_core(src.a, src.b, src.mask, trg, is_local, max_range)
    metric0 = fs0.avg_distance if is_local else fs0.real_avg_distance
    score0 = weight_fn(metric0, fs0.coverage_percentage, torch.zeros_like(metric0))

    # ---- phase 1: edge x edge candidates
    R, t, valid = _edge_candidates(src_edges, trg_edges)
    valid = valid & (torch.linalg.norm(t, dim=-1) <= max_distance)
    if is_local or constrain_angle:
        valid = valid & (R[..., 0, 0] >= cos_max)
    K = cfg.l_candidate_capacity if is_local else cfg.g_candidate_capacity
    R, t, valid = _compact_candidates(R, t, valid, K)
    scores1 = _chunked_scores(R, t, valid, src, trg, is_local, max_range,
                              weight_fn, chunk)
    best1 = torch.argmax(scores1, dim=-1, keepdim=True)
    s1 = _take(scores1, best1, 0)
    adopt1 = s1 > score0
    R1 = torch.where(adopt1[..., None, None], _take(R, best1, 2), eye)
    t1 = torch.where(adopt1[..., None], _take(t, best1, 1), 0.0)
    score_best = torch.maximum(score0, s1)

    # transformed source after phase 1
    src1 = src._replace(a=apply_rt(R1, t1, src.a), b=apply_rt(R1, t1, src.b))

    # ---- phase 2: per-line NN refinement on top of the phase-1 winner,
    # targets sorted by real distance per source line
    pfs = pairwise_scores(src1, trg)
    pvalid = src1.mask[..., :, None] & trg.mask[..., None, :]
    key = torch.where(pvalid, pfs.real_avg_distance, _INF)
    order = torch.argsort(key, dim=-1, stable=True)
    topk = 3 if is_local else 1
    nn_idx = order[..., :topk]                                   # (..., Ls, k)
    Ls = src1.a.shape[-2]
    sline_i = torch.arange(Ls, device=dev).repeat_interleave(topk)
    tline_i = nn_idx.flatten(-2)
    cvalid = torch.take_along_dim(pvalid, nn_idx, dim=-1).flatten(-2)

    sdir = gather_lines(_unit(src1.a - src1.b), sline_i)
    tdir = gather_lines(_unit(trg.a - trg.b), tline_i)
    cvalid = cvalid & (torch.abs((sdir * tdir).sum(-1)) >= cos_max)

    R2, t2 = align_lines_pair(gather_lines(src1.a, sline_i), gather_lines(src1.b, sline_i),
                              gather_lines(trg.a, tline_i), gather_lines(trg.b, tline_i))
    cvalid = cvalid & (torch.linalg.norm(t2, dim=-1) <= max_distance)
    scores2 = _chunked_scores(R2, t2, cvalid, src1, trg, is_local, max_range,
                              weight_fn, chunk)
    best2 = torch.argmax(scores2, dim=-1, keepdim=True)
    s2 = _take(scores2, best2, 0)
    adopt2 = s2 > score_best
    R2b = torch.where(adopt2[..., None, None], _take(R2, best2, 2), eye)
    t2b = torch.where(adopt2[..., None], _take(t2, best2, 1), 0.0)

    R_final = _matmul2(R2b, R1)
    t_final = _rotate(R2b, t1) + t2b
    aligned = src._replace(a=apply_rt(R_final, t_final, src.a),
                           b=apply_rt(R_final, t_final, src.b))
    return BestFitAlignment(
        transformation=_se3_from_rt(R_final, t_final),
        not_aligned_lines=src,
        aligned_lines=aligned,
        fitness=fitness_core(aligned.a, aligned.b, aligned.mask, trg, is_local, max_range),
        is_edge_aligned=adopt1,
        score=torch.maximum(score_best, s2),
    )


def _overlap_align(cfg: LineScanmatcherConfig, src: LineSegments, trg: LineSegments,
                   src_edges: EdgeFeatures, trg_edges: EdgeFeatures, center_b):
    """align_overlapped_buildings core (cpp:29-107): the minimum-translation
    transform among edge-edge and line-line candidates that leaves the two
    buildings apart, both expressed in building A's frame. Returns
    (T (..., 4, 4), aligned src, found (...))."""
    cos_max = math.cos(math.pi / 3.0)
    dev = src.a.device
    eye = torch.eye(2, dtype=src.a.dtype, device=dev)

    Re, te, ve = _edge_candidates(src_edges, trg_edges)

    Ls, Lt = src.a.shape[-2], trg.a.shape[-2]
    li = torch.arange(Ls, device=dev).repeat_interleave(Lt)
    lj = torch.arange(Lt, device=dev).repeat(Ls)
    Rl, tl = align_lines_pair(gather_lines(src.a, li), gather_lines(src.b, li),
                              gather_lines(trg.a, lj), gather_lines(trg.b, lj))
    vl = src.mask[..., li] & trg.mask[..., lj]

    R = torch.cat([Re, Rl], -3)
    t = torch.cat([te, tl], -2)
    valid = torch.cat([ve, vl], -1) & (R[..., 0, 0] > cos_max)

    # a candidate must leave the buildings non-overlapped
    center_b = center_b[..., None, :]
    center_a = torch.zeros_like(center_b)
    sa0, sb0 = src.a[..., None, :, :], src.b[..., None, :, :]
    ok = []
    for c0 in range(0, valid.shape[-1], cfg.score_chunk):
        Rc = R[..., c0:c0 + cfg.score_chunk, :, :]
        tc = t[..., c0:c0 + cfg.score_chunk, :]
        ov = are_buildings_overlapped(
            apply_rt(Rc, tc, sa0), apply_rt(Rc, tc, sb0), src.mask[..., None, :], center_a,
            trg.a[..., None, :, :], trg.b[..., None, :, :], trg.mask[..., None, :], center_b,
        )
        ok.append(valid[..., c0:c0 + cfg.score_chunk] & ~ov)
    ok = torch.cat(ok, -1)

    tnorm = torch.where(ok, torch.linalg.norm(t, dim=-1), _INF)
    best = torch.argmin(tnorm, dim=-1, keepdim=True)
    found = torch.isfinite(_take(tnorm, best, 0))
    Rb = torch.where(found[..., None, None], _take(R, best, 2), eye)
    tb = torch.where(found[..., None], _take(t, best, 1), 0.0)
    aligned = src._replace(a=apply_rt(Rb, tb, src.a), b=apply_rt(Rb, tb, src.b))
    return _se3_from_rt(Rb, tb), aligned, found


class LineBasedScanmatcher:
    """Facade with the reference's public API (hpp:126-130).

    ``sampler(max_lines, n_hypotheses)`` returns the RANSAC uniforms of one
    line extraction, a (max_lines, n_hypotheses, 2) tensor or array in
    [0, 1). By default it reads a torch.Generator seeded with 7 on
    ``device``; the JAX package draws from PRNGKey(7) instead, so the two
    default streams differ.
    """

    def __init__(self, cfg: LineScanmatcherConfig = LineScanmatcherConfig(),
                 device="cpu", sampler=None):
        self.cfg = cfg
        self.device = torch.device(device)
        if sampler is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(7)

            def sampler(n_lines, n_hypotheses):
                return torch.rand((n_lines, n_hypotheses, 2), generator=gen,
                                  device=self.device)
        self.sampler = sampler

    # ---- feature extraction -------------------------------------------
    def line_extraction(self, cloud: MaskedCloud) -> LineSegments:
        u = torch.as_tensor(self.sampler(self.cfg.max_lines, self.cfg.n_hypotheses),
                            device=cloud.points.device)
        return ransac_line(
            cloud, u,
            dist_thresh=self.cfg.sac_distance_threshold,
            min_cluster_size=self.cfg.min_cluster_size,
            max_cluster_size=self.cfg.max_cluster_size,
            cluster_tolerance=self.cfg.cluster_tolerance,
            merror_threshold=self.cfg.merror_threshold,
            length_threshold=self.cfg.line_length_threshold,
        )

    def merge_target_lines(self, lines: LineSegments, device) -> LineSegments:
        """Host-side exact merge, re-padded to target capacity on ``device``."""
        m = lines.mask.cpu().numpy()
        ma, mb = merge_lines(lines.a.cpu().numpy()[m], lines.b.cpu().numpy()[m])
        return make_lines(ma, mb, capacity=self.cfg.max_target_lines,
                          dtype=lines.a.dtype, device=device)

    # ---- alignments ----------------------------------------------------
    def align_global(self, cloud_or_lines, target_lines: LineSegments,
                     constrain_angle=False, max_range=np.inf,
                     merge_targets=True) -> BestFitAlignment:
        if isinstance(cloud_or_lines, MaskedCloud):
            src = self.line_extraction(cloud_or_lines)
        else:
            src = cloud_or_lines
        trg = (self.merge_target_lines(target_lines, src.a.device) if merge_targets
               else target_lines)
        se = edge_extraction(src, capacity=self.cfg.edge_capacity)
        te = edge_extraction(trg, capacity=self.cfg.target_edge_capacity)
        return _align(self.cfg, False, src, trg, se, te, bool(constrain_angle),
                      float(max_range))

    def align_local(self, src_lines: LineSegments, target_lines: LineSegments,
                    max_range=np.inf) -> BestFitAlignment:
        # src is a building outline in the delta flow (<= ~16 lines whose
        # angular edges are true polygon corners): the small capacity keeps
        # the Es x Et candidate cross proportional to reality
        se = edge_extraction(src_lines, only_angular_edges=True, max_dist_angular_edge=0.01,
                             capacity=self.cfg.building_edge_capacity)
        te = edge_extraction(target_lines, only_angular_edges=True, max_dist_angular_edge=7.0,
                             capacity=self.cfg.target_edge_capacity)
        return _align(self.cfg, True, src_lines, target_lines, se, te, False, float(max_range))

    def align_local_batch(self, src_stack: LineSegments, tgt_stack: LineSegments,
                          Ts, Tt, max_range=0.5) -> BestFitAlignment:
        """Batched align_local over B (building, scan) pairs: line sets
        stacked on a leading (B,) axis, the per-pair frame transforms
        Ts/Tt (B,4,4) applied first (the reference runs one align_local
        per keyframe x near building, delta_graph_slam_nodelet.cpp:687).
        Pairs with all-False line masks return identity transforms."""
        return self.align_local(transform_lines(src_stack, Ts),
                                transform_lines(tgt_stack, Tt), max_range)

    def align_overlapped_batch(self, la_stack: LineSegments, lb_stack: LineSegments,
                               poses_a, poses_b):
        """Batched align_overlapped_buildings over B overlapped pairs (the
        reference loops it per pair and de-overlap round,
        delta_graph_slam_nodelet.cpp:873-885).

        la_stack/lb_stack: line sets with a leading (B,) axis in the MAP
        frame; poses_a/poses_b: (B, 3) SE2 building estimates. Returns
        (T_map (B,4,4), found (B,) bool). Pairs with all-False masks
        return found=False.
        """
        dtype, dev = la_stack.a.dtype, la_stack.a.device
        pa = torch.as_tensor(poses_a, dtype=dtype, device=dev)
        pb = torch.as_tensor(poses_b, dtype=dtype, device=dev)
        R = rot2(pa[:, 2])
        t = pa[:, :2]
        Rt = R.transpose(-1, -2)
        zero = torch.zeros_like(t)

        # into A's frame (the reference aligns in building A's local frame,
        # line_based_scanmatcher.cpp:29-107)
        def to_local(lines):
            return lines._replace(a=apply_rt(Rt, zero, lines.a - t[:, None, :]),
                                  b=apply_rt(Rt, zero, lines.b - t[:, None, :]))

        la, lb = to_local(la_stack), to_local(lb_stack)
        rel = se2_compose(se2_inverse(pa), pb)
        # both sides are building outlines: small edge capacities
        ea = edge_extraction(la, capacity=self.cfg.building_edge_capacity)
        eb = edge_extraction(lb, capacity=self.cfg.building_edge_capacity)
        T_local, _, found = _overlap_align(self.cfg, la, lb, ea, eb, rel[:, :2])
        # back to the map frame: T_map = P T_local P^-1
        P = _se3_from_rt(R, t)
        Pinv = _se3_from_rt(Rt, -_rotate(Rt, t))
        return P @ T_local @ Pinv, found

    def align_overlapped_buildings(self, lines_a: LineSegments, pose_a,
                                   lines_b: LineSegments, pose_b):
        """One pair through align_overlapped_batch; pose_a/pose_b: (3,)
        SE2 estimates of the buildings.

        Returns (T_map (4,4) float64 numpy, found bool): the transform in
        the map frame that moves building A off building B with minimum
        translation.
        """
        def one(lines):
            return LineSegments(*(x[None] for x in lines))

        T, found = self.align_overlapped_batch(one(lines_a), one(lines_b),
                                               np.asarray(pose_a)[None], np.asarray(pose_b)[None])
        return T[0].cpu().numpy().astype(np.float64), bool(found[0])
