"""The registration engine: one Gauss-Newton loop, ICP and GICP heads.

Each iteration reduces to (correspondence search) -> (per-residual 3x6
Jacobian with 3x3 information) -> (summed 6x6 normal equations) ->
(closed SE3 update). Correspondences come from the voxel hash
(``nn_method='voxel'``, the delta preset) or from the exact 1-NN
(``'brute'``), which on the card is the Hopper kernel of ops/nn_kernel.py.

Heads:
- icp   : point-to-point, nearest neighbour, M = I
- gicp  : fast_gicp semantics - per-point covariances (kNN k=20, 'plane'
          regularized), NN correspondence, M = (C_b + R C_a R^T)^-1

The vgicp and ndt heads of the JAX package are not ported yet and raise.
"""

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..geom.se3 import _skew, se3_exp
from ..ops.cloud import MaskedCloud
from ..ops.knn import nn_1
from ..ops.voxel import VoxelHash, build_voxel_hash
from ..ops.voxel_knn import voxel_knn_covariances, voxel_nn
from .config import RegistrationConfig
from .covariance import knn_covariances

# The JAX package forces Precision.HIGHEST on these products; the
# counterpart on the card is full float32, never TF32.
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class TargetModel(NamedTuple):
    points: torch.Tensor            # (M,3)
    mask: torch.Tensor              # (M,)
    covs: Optional[torch.Tensor]    # (M,3,3) regularized (gicp) or None
    vh: Optional[VoxelHash]         # NN hash (nn_method='voxel') or None


class SourceModel(NamedTuple):
    points: torch.Tensor            # (N,3)
    mask: torch.Tensor              # (N,)
    covs: Optional[torch.Tensor]    # (N,3,3) regularized (gicp) or None


class RegistrationResult(NamedTuple):
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
    """
    w = valid.to(p.dtype)
    Mw = M * w[:, None, None]
    S = _skew(p)
    MS = Mw @ S
    StMS = S.transpose(-1, -2) @ MS
    H_tt = Mw.sum(0)
    H_tw = -MS.sum(0)
    H_ww = StMS.sum(0)
    H = torch.cat([torch.cat([H_tt, H_tw], 1), torch.cat([H_tw.T, H_ww], 1)], 0)
    Mr = (Mw @ r[..., None])[..., 0]
    b_t = Mr.sum(0)
    # J_w = -skew(p), so b_w = J_w^T M r = (-S)^T M r = +S M r
    b_w = (S @ Mr[..., None])[..., 0].sum(0)
    return H, torch.cat([b_t, b_w]), (r * Mr).sum()


def _transform(points, T):
    return points @ T[:3, :3].T + T[:3, 3]


def _make_correspondence_fns(cfg: RegistrationConfig):
    """(find, evaluate): ``find`` runs the candidate search and returns
    (target index, found) per source point; ``evaluate`` turns that state
    and the current transform into residuals. Splitting them lets the GN
    loop reuse correspondences across iterations (cfg.nn_reuse)."""
    max_d2 = cfg.max_correspondence_distance**2
    nn_offsets = _neighbor_offsets(cfg.nn_voxel_cells)

    def find(T, src: SourceModel, tgt: TargetModel):
        p = _transform(src.points, T)
        if cfg.nn_method == "voxel":
            # candidate-bounded NN over the target hash (tgt.points is the
            # hash's sorted order; see _build_target_model)
            _, j, ok = voxel_nn(tgt.vh, p, src.mask, nn_offsets,
                                window=cfg.nn_voxel_window, max_d2=max_d2)
            return j, ok
        d2, j = nn_1(p, src.mask, tgt.points, tgt.mask, chunk=cfg.chunk)
        return j.to(torch.int64), torch.isfinite(d2)

    def evaluate(T, st, src: SourceModel, tgt: TargetModel):
        R = T[:3, :3]
        p = _transform(src.points, T)
        j, ok = st
        r = p - tgt.points[j]
        d2 = (r * r).sum(-1)
        valid = ok & src.mask & (d2 < max_d2)
        if cfg.head == "icp":
            M = torch.eye(3, dtype=p.dtype, device=p.device).expand(r.shape + (3,))
        else:
            Ca = R @ src.covs @ R.T
            M = inv3x3(tgt.covs[j] + Ca)
        return p, r, M, valid

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


def _build_target_model(cfg: RegistrationConfig, capacity_voxels: int,
                        cloud: MaskedCloud) -> TargetModel:
    points, mask, vh = _model_cloud(cfg, capacity_voxels, cloud)
    covs = _gicp_covs(cfg, vh, cloud) if cfg.head == "gicp" else None
    return TargetModel(points, mask, covs, vh)


def _build_source_model(cfg: RegistrationConfig, capacity_voxels: int,
                        cloud: MaskedCloud) -> SourceModel:
    if cfg.head != "gicp":
        return SourceModel(cloud.points, cloud.mask, None)
    points, mask, vh = _model_cloud(cfg, capacity_voxels, cloud)
    return SourceModel(points, mask, _gicp_covs(cfg, vh, cloud))


class Registration:
    """Stateful facade mirroring pcl::Registration usage:
    set_target(cloud) once per keyframe, align(source, guess) per scan.
    """

    def __init__(self, cfg: RegistrationConfig, capacity_voxels: int = 8192):
        if cfg.cov_method == "auto":
            cfg = dataclasses.replace(cfg, cov_method="knn")
        if cfg.head not in ("icp", "gicp"):
            raise NotImplementedError(
                f"registration head {cfg.head!r} ({cfg.method}) is not ported")
        if cfg.cov_method != "knn":
            raise NotImplementedError(
                f"cov_method {cfg.cov_method!r} is not ported (only 'knn')")
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
