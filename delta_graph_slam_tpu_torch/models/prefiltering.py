"""Prefiltering stage.

Reproduces PrefilteringNodelet::cloud_callback
(prefiltering_nodelet.cpp:111-164):

  [deskew] -> base_link reframe (translation x/y zeroed, :141-142) ->
  distance filter -> voxel downsample -> outlier removal         -> 3-D out
  -> height filter -> normal filter (|n_z|<0.2, k=10) -> flatten -> 2-D out

over fixed-capacity masked clouds on the stage's device; both outputs
come back compacted. With ``deskewing`` on, a scan given an angular
velocity is first rotated point by point (ops/cloud.py:deskew); a scan
without one passes unchanged, as in the reference.
"""

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..ops.cloud import (
    MaskedCloud, compact, deskew, distance_filter, flatten_z, height_filter,
    make_cloud, transform_cloud,
)
from ..ops.normals import normal_filter
from ..ops.outliers import radius_outlier_removal, statistical_outlier_removal
from ..ops.voxel import voxel_downsample
from ..utils.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class PrefilteringConfig:
    downsample_method: str = "VOXELGRID"      # VOXELGRID | APPROX_VOXELGRID | NONE
    downsample_resolution: float = 0.1
    outlier_removal_method: str = "RADIUS"    # STATISTICAL | RADIUS | NONE
    statistical_mean_k: int = 20
    statistical_stddev: float = 1.0
    radius_radius: float = 0.8
    radius_min_neighbors: int = 2
    use_distance_filter: bool = True
    distance_near_thresh: float = 1.0
    distance_far_thresh: float = 100.0
    scan_period: float = 0.1
    deskewing: bool = False
    normal_filter_thresh: float = 0.2         # fixed in reference (:181, :238)
    normal_k: int = 10
    normal_radius: float = 0.75               # dense path: radius-search normals
    # capacities (static shapes)
    raw_capacity: int = 131072
    out_capacity: int = 32768
    chunk: int = 2048
    # neighbour search for the radius filter and normals: 'dense' (exact
    # radius statistics through the masked-moments products,
    # ops/moments.py), 'voxel' (hash-bounded kNN candidates) or 'brute'
    # (exact tiled kNN). 'auto' resolves to 'voxel', the reference's choice
    # off the TPU (prefiltering.py:83-87); its choice on a TPU, 'dense', is
    # a TPU layout decision, left to a measurement on the card.
    neighbor_method: str = "auto"


class PrefilterOutput(NamedTuple):
    filtered3d: MaskedCloud
    filtered2d: MaskedCloud


def colored_by_order(points: np.ndarray) -> np.ndarray:
    """Debug colours encoding acquisition order (the reference's
    /colored_points deskew aid, prefiltering_nodelet.cpp:300-318):
    r = 255*t, g = 128, b = 255*(1-t). Returns (N,3) uint8."""
    n = max(len(points), 1)
    t = np.arange(len(points), dtype=np.float64) / n
    return np.stack(
        [255 * t, np.full(len(points), 128.0), 255 * (1 - t)], axis=1
    ).astype(np.uint8)


def _resolve_neighbor_method(cfg: PrefilteringConfig) -> PrefilteringConfig:
    if cfg.neighbor_method == "auto":
        cfg = dataclasses.replace(cfg, neighbor_method="voxel")
    if cfg.neighbor_method not in ("voxel", "brute", "dense"):
        raise ValueError(f"unknown neighbor_method {cfg.neighbor_method!r}")
    return cfg


def run(cfg: PrefilteringConfig, cloud: MaskedCloud, base_T,
        lidar_height: float, angular_velocity=None) -> PrefilterOutput:
    """The per-scan filter chain (the reference's jitted ``run``); the scan
    is deskewed first when ``cfg.deskewing`` is on and an angular velocity
    is given."""
    if cfg.deskewing and angular_velocity is not None:
        cloud = deskew(cloud, angular_velocity, cfg.scan_period)
    cloud = transform_cloud(cloud, base_T)
    if cfg.use_distance_filter:
        cloud = distance_filter(
            cloud, cfg.distance_near_thresh, cfg.distance_far_thresh
        )
    if cfg.downsample_method in ("VOXELGRID", "APPROX_VOXELGRID"):
        # the downsample sorts by cell anyway: no pre-compaction needed
        c3 = voxel_downsample(
            cloud, cfg.downsample_resolution, capacity_out=cfg.out_capacity
        )
    else:
        # passthrough: compact then truncate to out_capacity
        cloud = compact(cloud)
        c3 = MaskedCloud(
            cloud.points[: cfg.out_capacity], cloud.mask[: cfg.out_capacity]
        )
    if cfg.outlier_removal_method == "STATISTICAL":
        c3 = statistical_outlier_removal(
            c3, cfg.statistical_mean_k, cfg.statistical_stddev, chunk=cfg.chunk,
        )
    elif cfg.outlier_removal_method == "RADIUS":
        c3 = radius_outlier_removal(
            c3, cfg.radius_radius, cfg.radius_min_neighbors,
            chunk=cfg.chunk, method=cfg.neighbor_method,
        )
    c3 = compact(c3)

    c2 = height_filter(c3, lidar_height)
    c2 = normal_filter(
        c2, cfg.normal_filter_thresh, cfg.normal_k,
        viewpoint=(0.0, 0.0, 0.0), keep_vertical_surfaces=True,
        chunk=cfg.chunk, method=cfg.neighbor_method, radius=cfg.normal_radius,
    )
    c2 = compact(flatten_z(c2))
    return PrefilterOutput(c3, c2)


class PrefilteringStage:
    """Host facade. ``process(points, base_T)`` -> PrefilterOutput on
    ``device``.

    base_T: sensor->base_link transform; its x/y translation is zeroed to
    keep scans centred (prefiltering_nodelet.cpp:141-142) and its z
    becomes the lidar height used by the 2-D branch.
    """

    def __init__(self, cfg: PrefilteringConfig = PrefilteringConfig(),
                 device=DEFAULT_DEVICE):
        self.cfg = _resolve_neighbor_method(cfg)
        self.device = resolve_device(device)

    def process(self, points: np.ndarray, base_T: Optional[np.ndarray] = None,
                angular_velocity=None) -> PrefilterOutput:
        """``angular_velocity`` (3,) rad/s: the IMU sample that deskews this
        scan when the config turns deskewing on; ignored otherwise."""
        cfg = self.cfg
        points = np.asarray(points)[: cfg.raw_capacity]
        cloud = make_cloud(points, capacity=cfg.raw_capacity, device=self.device)
        base_T = np.array(np.eye(4) if base_T is None else base_T, np.float32)
        lidar_height = float(base_T[2, 3])
        base_T[0, 3] = 0.0
        base_T[1, 3] = 0.0
        if angular_velocity is not None:
            angular_velocity = torch.from_numpy(
                np.array(angular_velocity, np.float32)).to(self.device)
        return run(cfg, cloud, torch.from_numpy(base_T).to(self.device),
                   lidar_height, angular_velocity)
