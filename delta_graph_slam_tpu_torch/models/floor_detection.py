"""Floor-plane detection stage.

Reproduces FloorDetectionNodelet::detect (floor_detection_nodelet.cpp:110-180):

  tilt compensation (rotate by tilt_deg about Y) -> height clip to
  [sensor_height - clip, sensor_height + clip] -> optional normal filter
  (|n.z| > cos(normal_filter_thresh deg), viewpoint (0,0,sensor_height))
  -> many-hypothesis RANSAC plane (thresh 0.1) -> support-count gate
  (floor_pts_thresh) -> verticality gate (floor_normal_thresh deg) ->
  normal sign made upward.

Returns the plane coefficients (a,b,c,d) in the *untilted* sensor frame or
None: the FloorCoeffs contract. The whole program runs on the stage's
device; the accept decision and the coefficients come back in one host read
a frame.
"""

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..ops.cloud import MaskedCloud, compact, make_cloud, plane_clip
from ..ops.normals import estimate_normals
from ..ops.ransac import ransac_plane, refine_plane
from ..utils.device import DEFAULT_DEVICE, resolve_device, strict_fp32_matmul


@dataclasses.dataclass(frozen=True)
class FloorDetectionConfig:
    tilt_deg: float = 0.0
    sensor_height: float = 2.0
    height_clip_range: float = 1.0
    floor_pts_thresh: int = 512
    floor_normal_thresh: float = 10.0     # degrees
    use_normal_filtering: bool = True
    normal_filter_thresh: float = 20.0    # degrees
    ransac_dist_thresh: float = 0.1       # fixed in reference (:140)
    n_hypotheses: int = 512
    capacity: int = 32768
    chunk: int = 2048
    # capacity of the height-clipped band the normal filter and RANSAC run
    # on. The clip keeps only points within +-clip_range of the floor (a few
    # thousand of a 16-32k scan), so the kNN normals pass costs O(band), not
    # O(scan capacity). Overflow drops the (stable-order) tail; 0 disables
    # the truncation.
    clip_capacity: int = 8192
    # neighbour source for the normal filter: 'brute' (exact tiled kNN),
    # 'voxel' (hash-bounded candidates) or 'dense' (radius statistics through
    # the masked-moments products, ops/moments.py); 'auto' is 'brute', the
    # reference's choice off the TPU (its TPU choice is 'dense').
    neighbor_method: str = "auto"         # auto | brute | voxel | dense
    normal_radius: float = 0.75           # 'dense' path only


def detect_floor(cfg: FloorDetectionConfig, cloud: MaskedCloud, uniforms):
    """The per-frame program: (coeffs (4,), ok (), n_inliers ()) on the
    cloud's device, from RANSAC uniforms ``(n_hypotheses, 3)``."""
    t = np.deg2rad(cfg.tilt_deg)
    ct, st = np.cos(t), np.sin(t)
    dtype, dev = cloud.points.dtype, cloud.points.device
    tilt = torch.tensor([[ct, 0, st], [0, 1, 0], [-st, 0, ct]], dtype=dtype,
                        device=dev)
    c = MaskedCloud(cloud.points @ tilt.T, cloud.mask)
    # keep the band -(h+clip) < z < -(h-clip) (floor_detection:118-119)
    c = plane_clip(c, [0.0, 0.0, 1.0, cfg.sensor_height + cfg.height_clip_range],
                   negative=False)
    c = plane_clip(c, [0.0, 0.0, 1.0, cfg.sensor_height - cfg.height_clip_range],
                   negative=True)
    # re-pack the clipped band to its own (small) capacity
    c = compact(c)
    if cfg.clip_capacity and cfg.clip_capacity < c.points.shape[0]:
        c = MaskedCloud(c.points[: cfg.clip_capacity], c.mask[: cfg.clip_capacity])
    if cfg.use_normal_filtering:
        method = "brute" if cfg.neighbor_method == "auto" else cfg.neighbor_method
        n, valid = estimate_normals(
            c, k=10, viewpoint=(0.0, 0.0, cfg.sensor_height), chunk=cfg.chunk,
            method=method, radius=cfg.normal_radius)
        keep = torch.abs(n[:, 2]) > math.cos(math.radians(cfg.normal_filter_thresh))
        c = MaskedCloud(c.points, c.mask & valid & keep)
    c = compact(c)
    n_filtered = c.mask.sum()

    res = ransac_plane(c, uniforms, dist_thresh=cfg.ransac_dist_thresh,
                       min_inliers=cfg.floor_pts_thresh)
    coeffs = refine_plane(c.points, res.inliers, res.coeffs)

    # verticality check against the tilted up-axis (:152-161)
    ref = tilt.T @ torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev)
    dot = torch.abs((coeffs[:3] * ref).sum())
    vertical_ok = dot > math.cos(math.radians(cfg.floor_normal_thresh))
    ok = ((n_filtered >= cfg.floor_pts_thresh)
          & (res.n_inliers >= cfg.floor_pts_thresh) & vertical_ok)
    # make the normal upward (:164-166)
    coeffs = torch.where(coeffs[2] < 0, -coeffs, coeffs)
    # de-tilt the plane back to the sensor frame
    return torch.cat([tilt.T @ coeffs[:3], coeffs[3:]]), ok, res.n_inliers


class FloorDetectionStage:
    """``sampler(n_hypotheses)`` returns one frame's RANSAC uniforms
    ``(n_hypotheses, 3)`` in [0, 1). By default it reads a torch.Generator
    seeded with 42 on the stage's device, so a run repeats; a test passes the
    JAX package's stream instead."""

    def __init__(self, cfg: FloorDetectionConfig = FloorDetectionConfig(),
                 device=DEFAULT_DEVICE, sampler=None):
        if cfg.neighbor_method not in ("auto", "brute", "voxel", "dense"):
            raise ValueError(f"unknown neighbor_method {cfg.neighbor_method!r}")
        self.cfg = cfg
        self.device = resolve_device(device)
        if sampler is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(42)

            def sampler(n_hypotheses):
                return torch.rand((n_hypotheses, 3), generator=gen,
                                  device=self.device)

        self.sampler = sampler

    def detect(self, cloud) -> Optional[np.ndarray]:
        """cloud: MaskedCloud or (N,3) array. Returns coeffs (4,) or None."""
        if not isinstance(cloud, MaskedCloud):
            cloud = make_cloud(np.asarray(cloud), capacity=self.cfg.capacity,
                               device=self.device)
        # in the sampler's own dtype: the index product is taken there
        u = torch.as_tensor(self.sampler(self.cfg.n_hypotheses), device=self.device)
        with strict_fp32_matmul():
            coeffs, ok, _ = detect_floor(self.cfg, cloud, u)
        out = torch.cat([coeffs, ok.to(coeffs.dtype)[None]]).cpu().numpy()
        return out[:4] if out[4] else None
