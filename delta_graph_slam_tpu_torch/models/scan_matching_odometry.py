"""Frame-to-keyframe scan-matching odometry.

Reproduces ScanMatchingOdometryNodelet::matching
(scan_matching_odometry_nodelet.cpp:173-270):

- first frame becomes the keyframe, pose = I;
- align the new frame against the keyframe with initial guess
  prev_trans @ msf_delta (IMU/robot-odometry delta when provided);
- non-convergence -> reuse prev_trans (:222-226);
- transform_thresholding -> reject jumps where |dt| or angle of
  prev_trans^-1 @ trans exceeds limits (:231-241);
- keyframe swap when delta translation/angle/time exceed thresholds
  (:249-260);
- odometry pose = keyframe_pose @ trans, flattened to SE2 for publication
  (publish_odometry :277-304);
- per-frame ScanMatchingStatus: convergence, fitness, inlier fraction
  (1-NN within 0.5 m, :309-346).
"""

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..geom.host import transform_3d_to_2d_np
from ..ops.cloud import MaskedCloud, make_cloud
from ..ops.knn import nn_1
from ..ops.voxel_knn import voxel_nn
from ..register.config import RegistrationConfig
from ..register.engine import Registration, make_registration
from ..utils.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class OdometryConfig:
    registration: RegistrationConfig = dataclasses.field(
        default_factory=lambda: RegistrationConfig(method="FAST_GICP")
    )
    keyframe_delta_trans: float = 0.25
    keyframe_delta_angle: float = 0.15
    keyframe_delta_time: float = 1.0
    transform_thresholding: bool = False
    max_acceptable_trans: float = 1.0
    max_acceptable_angle: float = 1.0
    downsample_method: str = "NONE"
    downsample_resolution: float = 0.1
    status_max_correspondence_dist: float = 0.5


class OdometryFrame(NamedTuple):
    """Odometry result + telemetry (the ScanMatchingStatus contract)."""

    pose: np.ndarray           # (4,4) odometry pose
    pose2d: np.ndarray         # (3,) flattened SE2
    converged: bool
    matching_error: float      # registration fitness (mean sq distance)
    inlier_fraction: float
    relative_pose: np.ndarray  # (4,4) final registration transform
    keyframe_swapped: bool
    rejected: bool             # frame ignored (non-convergence / jump)
    # ScanMatchingStatus prediction telemetry (:333-341): the error between
    # the final transform and the externally predicted delta, when provided
    prediction_label: str = ""
    prediction_error: np.ndarray = None  # (4,4) T^-1 @ msf_delta
    iterations: int = 0        # GN iterations = host syncs of the align loop


def _rotation_angle(T):
    qw = np.clip(np.sqrt(max(0.0, 1.0 + np.trace(T[:3, :3]))) / 2.0, -1, 1)
    return np.arccos(qw)


class ScanMatchingOdometry:
    def __init__(self, cfg: OdometryConfig = OdometryConfig(),
                 device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.registration: Registration = make_registration(cfg.registration)
        reg_cfg = self.registration.cfg
        # candidate-cell reach covering the status gate for any voxel
        # resolution: the gate needs ceil(max_dist/res) cells each way
        rad = max(1, int(np.ceil(cfg.status_max_correspondence_dist
                                 / reg_cfg.nn_voxel_resolution)))
        rng = range(-rad, rad + 1)
        self._status_offsets = np.asarray(
            [[i, j, l] for i in rng for j in rng for l in rng], np.int32)
        self.keyframe: Optional[MaskedCloud] = None
        self._keyframe_target = None
        self.keyframe_pose = np.eye(4)
        self.keyframe_stamp = 0.0
        self.prev_trans = np.eye(4)
        self.prev_time = 0.0

    def reset(self):
        self.keyframe = None
        self._keyframe_target = None
        self.keyframe_pose = np.eye(4)
        self.prev_trans = np.eye(4)
        self.prev_time = 0.0

    def _set_keyframe(self, cloud: MaskedCloud, stamp: float):
        self.keyframe = cloud
        self._keyframe_target = self.registration.build_target(cloud)
        self.keyframe_stamp = stamp

    def _status_step(self, cloud: MaskedCloud, guess):
        """Source-model build + GN align + status inlier fraction."""
        reg_cfg = self.registration.cfg
        tgt = self._keyframe_target
        res = self.registration.align_pair(cloud, tgt, guess)
        T = res.transformation
        moved = cloud.points @ T[:3, :3].T + T[:3, 3]
        n = torch.clamp(cloud.mask.sum(), min=1)
        max_d2 = self.cfg.status_max_correspondence_dist**2
        if reg_cfg.nn_method == "voxel":
            _, _, ok = voxel_nn(tgt.vh, moved, cloud.mask, self._status_offsets,
                                window=reg_cfg.nn_voxel_window, max_d2=max_d2)
            frac = ok.sum() / n
        else:
            d2, _ = nn_1(moved, cloud.mask, tgt.points, tgt.mask,
                         chunk=reg_cfg.chunk)
            frac = (cloud.mask & (d2 < max_d2)).sum() / n
        return res, frac

    def save_state(self, path):
        """Checkpoint the odometry stage (keyframe cloud + frame state)."""
        kf_pts = (
            self.keyframe.points[self.keyframe.mask].cpu().numpy()
            if self.keyframe is not None else np.zeros((0, 3), np.float32)
        )
        np.savez_compressed(
            path, keyframe_points=kf_pts,
            keyframe_pose=self.keyframe_pose, prev_trans=self.prev_trans,
            keyframe_stamp=np.float64(self.keyframe_stamp),
            prev_time=np.float64(self.prev_time),
        )

    def load_state(self, path, capacity=32768):
        z = np.load(path)
        self.keyframe_pose = z["keyframe_pose"]
        self.prev_trans = z["prev_trans"]
        self.keyframe_stamp = float(z["keyframe_stamp"])
        self.prev_time = float(z["prev_time"])
        pts = z["keyframe_points"]
        if len(pts):
            self._set_keyframe(make_cloud(pts, capacity=capacity,
                                          device=self.device),
                               self.keyframe_stamp)

    def matching(self, stamp: float, cloud: MaskedCloud,
                 msf_delta: Optional[np.ndarray] = None,
                 msf_source: str = "") -> OdometryFrame:
        if self.keyframe is None:
            self.prev_trans = np.eye(4)
            self.keyframe_pose = np.eye(4)
            self._set_keyframe(cloud, stamp)
            return OdometryFrame(
                pose=np.eye(4), pose2d=np.zeros(3), converged=True,
                matching_error=0.0, inlier_fraction=1.0,
                relative_pose=np.eye(4), keyframe_swapped=True,
                rejected=False,
            )

        guess = self.prev_trans @ (
            np.eye(4) if msf_delta is None else np.asarray(msf_delta)
        )
        res, frac_t = self._status_step(
            cloud, torch.as_tensor(guess, dtype=torch.float32, device=self.device))
        T = res.transformation.cpu().numpy().astype(np.float64)
        converged = res.converged
        fitness = float(res.fitness)
        frac = float(frac_t)

        if not converged:
            pose = self.keyframe_pose @ self.prev_trans
            return OdometryFrame(
                pose=pose, pose2d=transform_3d_to_2d_np(pose),
                converged=False, matching_error=fitness,
                inlier_fraction=frac, relative_pose=T,
                keyframe_swapped=False, rejected=True,
                iterations=res.iterations,
            )

        odom = self.keyframe_pose @ T
        pred_err = (
            np.linalg.inv(T) @ np.asarray(msf_delta)
            if msf_delta is not None else None
        )

        if self.cfg.transform_thresholding:
            delta = np.linalg.inv(self.prev_trans) @ T
            dx = np.linalg.norm(delta[:3, 3])
            da = _rotation_angle(delta)
            if dx > self.cfg.max_acceptable_trans or da > self.cfg.max_acceptable_angle:
                pose = self.keyframe_pose @ self.prev_trans
                return OdometryFrame(
                    pose=pose, pose2d=transform_3d_to_2d_np(pose),
                    converged=True, matching_error=fitness,
                    inlier_fraction=frac, relative_pose=T,
                    keyframe_swapped=False, rejected=True,
                    prediction_label=msf_source, prediction_error=pred_err,
                    iterations=res.iterations,
                )

        self.prev_time = stamp
        self.prev_trans = T

        # keyframe swap rule (:249-260)
        delta_trans = np.linalg.norm(T[:3, 3])
        delta_angle = _rotation_angle(T)
        delta_time = stamp - self.keyframe_stamp
        swapped = False
        if (
            delta_trans > self.cfg.keyframe_delta_trans
            or delta_angle > self.cfg.keyframe_delta_angle
            or delta_time > self.cfg.keyframe_delta_time
        ):
            self._set_keyframe(cloud, stamp)
            self.keyframe_pose = odom
            self.prev_trans = np.eye(4)
            swapped = True

        return OdometryFrame(
            pose=odom, pose2d=transform_3d_to_2d_np(odom),
            converged=True, matching_error=fitness,
            inlier_fraction=frac, relative_pose=T,
            keyframe_swapped=swapped, rejected=False,
            prediction_label=msf_source, prediction_error=pred_err,
            iterations=res.iterations,
        )
