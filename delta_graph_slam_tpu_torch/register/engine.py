"""The registration engine: one Gauss-Newton loop, four cost heads.

Each iteration reduces to (correspondence search) -> (per-residual 3x6
Jacobian with 3x3 information) -> (summed 6x6 normal equations) ->
(closed SE3 update). Point correspondences (icp, gicp) come from the voxel
hash (``nn_method='voxel'``, the delta preset) or from the exact 1-NN
(``'brute'``), which on the card is the Hopper kernel of ops/nn_kernel.py;
the voxel heads (vgicp, ndt) look the transformed points up in the target's
voxel-statistics hash.

Heads:
- icp   : point-to-point, nearest neighbour, M = I
- gicp  : fast_gicp semantics - per-point covariances (kNN k=20, 'plane'
          regularized), NN correspondence, M = (C_b + R C_a R^T)^-1
- vgicp : fast_vgicp - target voxel distributions, 27-neighbourhood,
          M = (S_v + R C_a R^T)^-1 per contributing voxel
- ndt   : voxel Gaussians, DIRECT7/DIRECT1 neighbourhoods, M = S_v^-1
          weighted by Magnusson's exponential score (IRLS)

The voxel heads are gathers and batched 3x3 algebra over K = N x offsets
residuals: plain PyTorch, no kernel of their own.

``_make_batched_align_fn`` is the counterpart of the JAX package's
``jax.vmap(_make_align_fn(cfg))`` (parallel/sharding.py, multibag.py): B
problems with stacked models run one launch sequence a GN iteration, each
frozen once its own step is below the threshold, as vmap of a while_loop
freezes it; brute correspondences are one batched launch of the 1-NN kernel.
"""

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..geom.se3 import _skew, se3_exp
from ..ops.cloud import MaskedCloud
from ..ops.knn import nn_1
from ..ops.voxel import VoxelHash, batch_take, build_voxel_hash, voxel_lookup
from ..ops.voxel_knn import voxel_knn_covariances, voxel_nn
from .config import RegistrationConfig
from .covariance import dense_covariances, knn_covariances, regularize_covariances

# The JAX package forces Precision.HIGHEST on these products; the
# counterpart on the card is full float32, never TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class TargetModel(NamedTuple):
    points: torch.Tensor            # (M,3)
    mask: torch.Tensor              # (M,)
    covs: Optional[torch.Tensor]    # (M,3,3) regularized (gicp) or None
    vh: Optional[VoxelHash]         # NN hash (icp/gicp, nn_method='voxel'),
                                    # statistics hash (vgicp/ndt) or None
    voxel_covs: Optional[torch.Tensor] = None      # (V,3,3) regularized (vgicp/ndt)
    voxel_inv_covs: Optional[torch.Tensor] = None  # (V,3,3) inverses (ndt)


class SourceModel(NamedTuple):
    points: torch.Tensor            # (N,3)
    mask: torch.Tensor              # (N,)
    covs: Optional[torch.Tensor]    # (N,3,3) regularized (gicp/vgicp) or None


class RegistrationResult(NamedTuple):
    # a batched align gives every field a leading B (converged and
    # iterations as (B,) tensors)
    transformation: torch.Tensor    # (4,4) T s.t. T @ source ~ target
    converged: bool
    iterations: int
    num_correspondences: torch.Tensor  # () int
    mean_error: torch.Tensor        # () float - mean Mahalanobis residual
    fitness: torch.Tensor           # () float - mean sq euclidean distance


def inv3x3(A, ridge=1e-9):
    """Closed-form batched 3x3 inverse with a tiny ridge."""
    A = A + ridge * torch.eye(3, dtype=A.dtype, device=A.device)
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, 1e-30, det)
    adj = torch.stack(
        [
            torch.stack([A11, A12, A13], -1),
            torch.stack([A21, A22, A23], -1),
            torch.stack([A31, A32, A33], -1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def _neighbor_offsets(n):
    if n == 1:
        offs = [[0, 0, 0]]
    elif n == 7:
        offs = [[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                [0, 0, 1], [0, 0, -1]]
    else:  # 27
        offs = [[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                for k in (-1, 0, 1)]
    return np.asarray(offs, np.int32)


def _normal_equations(p, r, M, valid):
    """Accumulate GN H (6,6) and b (6,) from residuals.

    p: (K,3) transformed source points (Jacobian anchor)
    r: (K,3) residuals, M: (K,3,3) information, valid: (K,) bool.
    J_k = [I | -skew(p_k)] (3,6) for left-multiplicative se3 updates.
    Leading dimensions are a batch of problems ((B,6,6) and (B,6)).
    """
    w = valid.to(p.dtype)
    Mw = M * w[..., None, None]
    S = _skew(p)
    MS = Mw @ S
    StMS = S.transpose(-1, -2) @ MS
    H_tt = Mw.sum(-3)
    H_tw = -MS.sum(-3)
    H_ww = StMS.sum(-3)
    H = torch.cat([torch.cat([H_tt, H_tw], -1),
                   torch.cat([H_tw.transpose(-1, -2), H_ww], -1)], -2)
    Mr = (Mw @ r[..., None])[..., 0]
    b_t = Mr.sum(-2)
    # J_w = -skew(p), so b_w = J_w^T M r = (-S)^T M r = +S M r
    b_w = (S @ Mr[..., None])[..., 0].sum(-2)
    return H, torch.cat([b_t, b_w], -1), (r * Mr).sum((-2, -1))


def _ndt_gauss_d2(resolution, outlier_ratio):
    """PCL NDT mixture coefficients; only d2 shapes the IRLS weight."""
    c1 = 10.0 * (1.0 - outlier_ratio)
    c2 = outlier_ratio / resolution**3
    d3 = -math.log(c2)
    d1 = -math.log(c1 + c2) - d3
    return -2.0 * math.log((-math.log(c1 * math.exp(-0.5) + c2) - d3) / d1)


def _transform(points, T):
    if T.ndim == 3:     # a batch: (B,N,3) points, (B,4,4) transforms
        return points @ T[:, :3, :3].transpose(-1, -2) + T[:, None, :3, 3]
    return points @ T[:3, :3].T + T[:3, 3]


def _make_correspondence_fns(cfg: RegistrationConfig):
    """(find, evaluate): ``find`` runs the candidate search and returns
    (target index, found) per source point, or (voxel slot, hit) per source
    point and neighbour cell for the voxel heads; ``evaluate`` turns that
    state and the current transform into residuals. Splitting them lets the
    GN loop reuse correspondences across iterations (cfg.nn_reuse).

    Both take a batch of problems as well: (B,4,4) transforms with models
    whose tensors are stacked per problem (parallel/multibag.py:_stack);
    every gather then reads each problem's own rows (ops/voxel.py:batch_take)
    and every output gains a leading B."""
    head = cfg.head
    max_d2 = cfg.max_correspondence_distance**2
    nn_offsets = _neighbor_offsets(cfg.nn_voxel_cells)
    offsets = _neighbor_offsets(cfg.neighbor_offsets)
    gauss_d2 = (_ndt_gauss_d2(cfg.resolution, cfg.ndt_outlier_ratio)
                if head == "ndt" else None)

    def find(T, src: SourceModel, tgt: TargetModel):
        p = _transform(src.points, T)
        if head in ("vgicp", "ndt"):
            # cells by the float32 reciprocal of the resolution (ops/voxel.py),
            # where the JAX align divides by it: the same cells at the
            # presets' power-of-two resolutions
            return voxel_lookup(tgt.vh, p, src.mask, offsets=offsets)
        if cfg.nn_method == "voxel":
            # candidate-bounded NN over the target hash (tgt.points is the
            # hash's sorted order; see _build_target_model)
            _, j, ok = voxel_nn(tgt.vh, p, src.mask, nn_offsets,
                                window=cfg.nn_voxel_window, max_d2=max_d2)
            return j, ok
        d2, j = nn_1(p, src.mask, tgt.points, tgt.mask, chunk=cfg.chunk)
        return j.to(torch.int64), torch.isfinite(d2)

    def evaluate(T, st, src: SourceModel, tgt: TargetModel):
        batched = T.ndim == 3
        R = T[..., :3, :3]
        Rt = R.transpose(-1, -2)
        if batched:
            R, Rt = R[:, None], Rt[:, None]
        p = _transform(src.points, T)
        if head in ("vgicp", "ndt"):
            return _evaluate_voxels(R, Rt, p, st, src, tgt, batched)
        j, ok = st
        r = p - batch_take(tgt.points, j, batched)
        d2 = (r * r).sum(-1)
        valid = ok & src.mask & (d2 < max_d2)
        if head == "icp":
            M = torch.eye(3, dtype=p.dtype, device=p.device).expand(r.shape + (3,))
        else:
            Ca = R @ src.covs @ Rt
            M = inv3x3(batch_take(tgt.covs, j, batched) + Ca)
        return p, r, M, valid

    def _evaluate_voxels(R, Rt, p, st, src: SourceModel, tgt: TargetModel,
                         batched):
        """K = N x offsets residuals: each source point against the mean of
        every hit voxel of its neighbourhood (row k*m + o: point k, offset o)."""
        slot, hit = st
        m = slot.shape[-1]
        slot_f = slot.reshape(slot.shape[:-2] + (-1,))
        rows = slot.ndim - 2            # the point axis
        p_rep = p.repeat_interleave(m, dim=rows)
        r = p_rep - batch_take(tgt.vh.means, slot_f, batched)
        d2 = (r * r).sum(-1)
        valid = hit.reshape(slot_f.shape) & (d2 < max_d2)
        if head == "ndt":
            M = batch_take(tgt.voxel_inv_covs, slot_f, batched)
            # Magnusson's exponential score: the IRLS weight saturates far
            # pulls (the same fixed points as PCL NDT's -d1 exp(-d2/2 e2))
            e2 = torch.einsum("...na,...nab,...nb->...n", r, M, r)
            M = M * torch.exp(-0.5 * gauss_d2 * e2)[..., None, None]
        else:
            Ca = R @ src.covs @ Rt
            M = inv3x3(batch_take(tgt.voxel_covs, slot_f, batched)
                       + Ca.repeat_interleave(m, dim=rows))
        return p_rep, r, M, valid

    return find, evaluate


def _make_align_fn(cfg: RegistrationConfig):
    find, evaluate = _make_correspondence_fns(cfg)
    eps2 = cfg.transformation_epsilon**2
    lam = cfg.lm_lambda
    reuse = max(int(cfg.nn_reuse), 1)

    def align(src: SourceModel, tgt: TargetModel, guess) -> RegistrationResult:
        T = torch.as_tensor(guess, dtype=src.points.dtype, device=src.points.device)
        eye6 = torch.eye(6, dtype=T.dtype, device=T.device)
        st = find(T, src, tgt)
        done, iters = False, 0
        while iters < cfg.maximum_iterations:
            p, r, M, valid = evaluate(T, st, src, tgt)
            H, b, _ = _normal_equations(p, r, M, valid)
            H = H + lam * torch.diag(torch.diag(H)) + 1e-9 * eye6
            delta = -torch.linalg.solve_ex(H, b).result
            delta = torch.where(torch.isfinite(delta).all(), delta, 0.0)
            T = se3_exp(delta) @ T
            iters += 1
            # The one host sync of each GN iteration: the reference's
            # lax.while_loop tests `done` on the device, this loop on the host.
            done = bool((delta * delta).sum() < eps2)
            if done or iters >= cfg.maximum_iterations:
                break
            if iters % reuse == 0:
                st = find(T, src, tgt)
        # final stats at the solution (fresh correspondences)
        st = find(T, src, tgt)
        p, r, M, valid = evaluate(T, st, src, tgt)
        w = valid.to(p.dtype)
        ncorr = valid.sum()
        cnt = torch.clamp(ncorr.to(p.dtype), min=1.0)
        Mr = (M @ r[..., None])[..., 0]
        return RegistrationResult(
            transformation=T,
            converged=done,
            iterations=iters,
            num_correspondences=ncorr,
            mean_error=(w * (r * Mr).sum(-1)).sum() / cnt,
            fitness=(w * (r * r).sum(-1)).sum() / cnt,
        )

    return align


def _make_batched_align_fn(cfg: RegistrationConfig):
    """B alignments in lockstep: the counterpart of the JAX package's
    ``jax.vmap(_make_align_fn(cfg))``.

    Takes a SourceModel and a TargetModel whose tensors are stacked per
    problem (parallel/multibag.py:_stack) and (B,4,4) guesses. Every GN
    iteration is one launch sequence for all B problems; a problem whose
    step fell below the threshold keeps its transform and iteration count
    from then on (vmap of the reference's while_loop freezes it the same
    way), and the loop ends when every problem is done or at
    maximum_iterations. Returns a RegistrationResult with a leading B on
    every field.
    """
    find, evaluate = _make_correspondence_fns(cfg)
    eps2 = cfg.transformation_epsilon**2
    lam = cfg.lm_lambda
    reuse = max(int(cfg.nn_reuse), 1)

    def align(src: SourceModel, tgt: TargetModel, guesses) -> RegistrationResult:
        T = torch.as_tensor(guesses, dtype=src.points.dtype, device=src.points.device)
        B = T.shape[0]
        eye6 = torch.eye(6, dtype=T.dtype, device=T.device)
        st = find(T, src, tgt)
        done = torch.zeros(B, dtype=torch.bool, device=T.device)
        iters = torch.zeros(B, dtype=torch.int64, device=T.device)
        it = 0
        while it < cfg.maximum_iterations:
            live = ~done
            p, r, M, valid = evaluate(T, st, src, tgt)
            H, b, _ = _normal_equations(p, r, M, valid)
            H = (H + lam * torch.diag_embed(torch.diagonal(H, dim1=-2, dim2=-1))
                 + 1e-9 * eye6)
            delta = -torch.linalg.solve_ex(H, b).result
            delta = torch.where(torch.isfinite(delta).all(-1, keepdim=True), delta, 0.0)
            T = torch.where(live[:, None, None], se3_exp(delta) @ T, T)
            done = done | (live & ((delta * delta).sum(-1) < eps2))
            iters = iters + live.to(torch.int64)
            it += 1
            # the one host read of each GN iteration: the (B,) done vector
            if all(done.tolist()) or it >= cfg.maximum_iterations:
                break
            if it % reuse == 0:
                st = find(T, src, tgt)
        # final stats at the solutions (fresh correspondences)
        st = find(T, src, tgt)
        p, r, M, valid = evaluate(T, st, src, tgt)
        w = valid.to(p.dtype)
        ncorr = valid.sum(-1)
        cnt = torch.clamp(ncorr.to(p.dtype), min=1.0)
        Mr = (M @ r[..., None])[..., 0]
        return RegistrationResult(
            transformation=T,
            converged=done,
            iterations=iters,
            num_correspondences=ncorr,
            mean_error=(w * (r * Mr).sum(-1)).sum(-1) / cnt,
            fitness=(w * (r * r).sum(-1)).sum(-1) / cnt,
        )

    return align


def _gicp_covs(cfg: RegistrationConfig, vh: Optional[VoxelHash], cloud):
    if vh is not None:
        covs, _ = voxel_knn_covariances(
            vh, k=cfg.correspondence_randomness,
            offsets=_neighbor_offsets(cfg.cov_voxel_cells),
            window=cfg.cov_voxel_window, mode="plane",
        )
        return covs
    covs, _ = knn_covariances(
        cloud.points, cloud.mask, k=cfg.correspondence_randomness,
        mode="plane", chunk=cfg.chunk,
    )
    return covs


def _model_cloud(cfg: RegistrationConfig, capacity_voxels: int, cloud: MaskedCloud):
    """(points, mask, hash) of a model: with nn_method='voxel' the points
    adopt the NN hash's cell-sorted order, so covariances, correspondence
    indices and points all line up."""
    if cfg.nn_method != "voxel":
        return cloud.points, cloud.mask, None
    vh = build_voxel_hash(cloud, cfg.nn_voxel_resolution, capacity_voxels,
                          dense_index=True, with_stats=False)
    return vh.sorted_points, vh.sorted_valid, vh


def _voxel_target_model(cfg: RegistrationConfig, capacity_voxels: int,
                        cloud: MaskedCloud) -> TargetModel:
    """The vgicp / ndt target: per-voxel statistics at ``cfg.resolution``,
    covariances regularized to 'plane' (vgicp) or 'floor' (ndt) form; voxels
    with fewer than 5 points get an identity covariance and, for ndt, a zero
    inverse (the PCL NDT gate), so they pull nothing."""
    vh = build_voxel_hash(cloud, cfg.resolution, capacity_voxels, dense_index=True)
    bad = (vh.counts < 5)[:, None, None]
    eye = torch.eye(3, dtype=vh.covs.dtype, device=vh.covs.device)
    covs = regularize_covariances(vh.covs, mode="plane" if cfg.head == "vgicp" else "floor")
    covs = torch.where(bad, eye, covs)
    inv = torch.where(bad, 0.0, inv3x3(covs)) if cfg.head == "ndt" else None
    return TargetModel(cloud.points, cloud.mask, None, vh, covs, inv)


def _dense_covs(cfg: RegistrationConfig, points, mask):
    covs, _ = dense_covariances(points, mask, radius=cfg.cov_dense_radius,
                                mode="plane")
    return covs


def _build_target_model(cfg: RegistrationConfig, capacity_voxels: int,
                        cloud: MaskedCloud) -> TargetModel:
    """As the reference (engine.py:285-329): with cov_method='dense' the
    gicp target's radius covariances are taken in the NN hash's order
    (nn_method='voxel'); a brute-force target keeps kNN covariances."""
    if cfg.head in ("vgicp", "ndt"):
        return _voxel_target_model(cfg, capacity_voxels, cloud)
    points, mask, vh = _model_cloud(cfg, capacity_voxels, cloud)
    covs = None
    if cfg.head == "gicp":
        covs = (_dense_covs(cfg, points, mask)
                if vh is not None and cfg.cov_method == "dense"
                else _gicp_covs(cfg, vh, cloud))
    return TargetModel(points, mask, covs, vh)


def _build_source_model(cfg: RegistrationConfig, capacity_voxels: int,
                        cloud: MaskedCloud) -> SourceModel:
    """With cov_method='dense' the source keeps its own order (no hash is
    needed for radius covariances), as in the reference (engine.py:338)."""
    if cfg.head not in ("gicp", "vgicp"):
        return SourceModel(cloud.points, cloud.mask, None)
    if cfg.cov_method == "dense":
        return SourceModel(cloud.points, cloud.mask,
                           _dense_covs(cfg, cloud.points, cloud.mask))
    points, mask, vh = _model_cloud(cfg, capacity_voxels, cloud)
    return SourceModel(points, mask, _gicp_covs(cfg, vh, cloud))


class Registration:
    """Stateful facade mirroring pcl::Registration usage:
    set_target(cloud) once per keyframe, align(source, guess) per scan.
    """

    def __init__(self, cfg: RegistrationConfig, capacity_voxels: int = 8192):
        if cfg.cov_method == "auto":
            cfg = dataclasses.replace(cfg, cov_method="knn")
        if cfg.cov_method not in ("knn", "dense"):
            raise ValueError(f"unknown cov_method {cfg.cov_method!r}")
        if cfg.nn_method not in ("voxel", "brute"):
            raise ValueError(f"unknown nn_method {cfg.nn_method!r}")
        self.cfg = cfg
        self.capacity_voxels = capacity_voxels
        self._target: Optional[TargetModel] = None
        self._align = _make_align_fn(cfg)

    def build_target(self, cloud: MaskedCloud) -> TargetModel:
        return _build_target_model(self.cfg, self.capacity_voxels, cloud)

    def build_source(self, cloud: MaskedCloud) -> SourceModel:
        return _build_source_model(self.cfg, self.capacity_voxels, cloud)

    def set_target(self, cloud: MaskedCloud):
        self._target = self.build_target(cloud)

    def align(self, source, guess=None) -> RegistrationResult:
        if self._target is None:
            raise RuntimeError("set_target() before align()")
        return self.align_pair(source, self._target, guess)

    def align_cloud(self, cloud: MaskedCloud, guess=None) -> RegistrationResult:
        """One scan registered against the prepared target: its source
        model built and aligned (the reference jits the two as one program)."""
        if self._target is None:
            raise RuntimeError("set_target() before align_cloud()")
        return self.align_pair(cloud, self._target, guess)

    def align_pair(self, source, target, guess=None) -> RegistrationResult:
        if isinstance(target, MaskedCloud):
            target = self.build_target(target)
        if isinstance(source, MaskedCloud):
            source = self.build_source(source)
        if guess is None:
            guess = torch.eye(4)
        return self._align(source, target, guess)


def make_registration(method_or_cfg="NDT_OMP", **kw) -> Registration:
    """Factory mirroring select_registration_method (registrations.cpp:22)."""
    if isinstance(method_or_cfg, RegistrationConfig):
        cfg = method_or_cfg
    else:
        cfg = RegistrationConfig(method=method_or_cfg, **kw)
    return Registration(cfg)
