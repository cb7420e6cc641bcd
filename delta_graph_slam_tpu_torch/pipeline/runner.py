"""End-to-end pipeline runner (the nodelet-manager equivalent).

Wires PrefilteringStage -> ScanMatchingOdometry -> DeltaBackend as
delta_graph_slam.launch wires the nodelets, on one explicit device, with
the backend's update step fired on the graph_update_interval cadence of
the message stamps. Single-threaded; the reference's threaded stage
pipeline is not ported yet.
"""

from typing import Optional

import numpy as np
import torch

from ..config.presets import PipelineConfig
from ..models.delta_backend import DeltaBackend
from ..models.prefiltering import PrefilteringStage
from ..models.scan_matching_odometry import ScanMatchingOdometry
from ..utils.device import resolve_device
from ..utils.profiling import StageTimer


class Pipeline:
    def __init__(self, cfg: PipelineConfig, building_provider=None,
                 base_T: Optional[np.ndarray] = None, device="cpu"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.prefiltering = PrefilteringStage(cfg.prefiltering, self.device)
        self.odometry = ScanMatchingOdometry(cfg.odometry, self.device)
        self.backend = DeltaBackend(cfg.delta, building_provider, self.device)
        self._interval = cfg.delta.graph_update_interval
        self.base_T = np.eye(4) if base_T is None else np.asarray(base_T)
        # stage clocks wait for the card, so each stage is charged its own work
        self.timer = StageTimer(
            sync=torch.cuda.synchronize if self.device.type == "cuda" else None)
        self._last_opt_stamp = None

    def on_gps(self, stamp, lat, lon, alt=0.0):
        self.backend.gps_callback(stamp, lat, lon, alt)

    def on_nmea(self, stamp, sentence):
        self.backend.nmea_callback(stamp, sentence)

    def on_points(self, stamp, points, gt_pose=None):
        """Full per-scan path: prefilter -> odometry -> backend enqueue."""
        with self.timer.stage("prefiltering"):
            out = self.prefiltering.process(points, base_T=self.base_T)
        with self.timer.stage("odometry"):
            frame = self.odometry.matching(stamp, out.filtered3d)
        with self.timer.stage("backend_enqueue"):
            self.backend.cloud_callback(
                stamp, frame.pose, out.filtered3d, out.filtered2d,
                gt_pose=gt_pose,
            )
        # graph-update timer on message time
        if self._last_opt_stamp is None:
            self._last_opt_stamp = stamp
        if stamp - self._last_opt_stamp >= self._interval:
            self.optimize()
            self._last_opt_stamp = stamp
        return frame

    def optimize(self):
        with self.timer.stage("optimization_step"):
            return self.backend.optimization_step()

    def finish(self):
        """A final optimization: at least one update step and up to ten,
        until one changes nothing and the keyframe queue is empty."""
        stats = {}
        for _ in range(10):
            s = self.optimize()
            if not s and not self.backend.keyframe_queue:
                break
            stats = s or stats
        return stats

    def save_map(self, destination, resolution=0.05):
        return self.backend.save_map(destination, resolution)

    def evaluate(self):
        return self.backend.compute_ate_rpe()

    def timing_summary(self):
        out = dict(self.timer.summary())
        out.update({f"backend.{k}": v
                    for k, v in self.backend.timer.summary().items()})
        return out
