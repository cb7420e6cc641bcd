"""The delta graph-SLAM backend, first part: keyframes and odometry edges.

Rebuild of the keyframe path of DeltaGraphSlamNodelet
(delta_graph_slam_nodelet.cpp): keyframe admission, and for each pair of
consecutive keyframes an SE2 odometry edge whose information matrix comes
from the scan-match fitness (:416-455 of the JAX package's
delta_backend.py). The edges are recorded in ``PoseGraphLog`` lists; the
graph solve, GPS priors, OSM buildings and loop closure come with later
ports.

Divergence until GPS and buildings land: there is no building manager, so
``cloud_callback`` does not wait for the first GPS fix (the reference
returns early at :354-356 until one arrives). It behaves like the
reference with a building provider that returns no buildings.
"""

import dataclasses
from typing import List, Optional

import numpy as np

from ..geom.host import se2_compose_np, se2_inverse_np, transform_3d_to_2d_np
from ..pipeline.information_matrix import InformationMatrixCalculator
from ..pipeline.keyframe import KeyFrame
from ..pipeline.keyframe_updater import KeyframeUpdater
from ..utils.device import resolve_device
from ..utils.profiling import StageTimer


@dataclasses.dataclass(frozen=True)
class DeltaBackendConfig:
    """The fields of the reference's DeltaBackendConfig that the slice reads."""

    max_keyframes_per_update: int = 10
    keyframe_delta_trans: float = 2.0
    keyframe_delta_angle: float = 2.0
    fix_first_node: bool = True
    graph_update_interval: float = 3.0
    odometry_edge_robust_kernel: str = "NONE"
    odometry_edge_robust_kernel_size: float = 1.0
    init_x: float = 0.0
    init_y: float = 0.0
    init_angle_deg: float = 0.0
    inf: InformationMatrixCalculator = dataclasses.field(
        default_factory=lambda: InformationMatrixCalculator(
            b_var_gain_a=7.0, b_max_stddev_x=2.0,
            b_avg_fitness_score=1.75,
            b_importance_ratio_global=500.0, b_importance_ratio_local=25.0,
        )
    )


class PoseGraphLog:
    """Vertices and SE2 edges of the pose graph in plain lists, with the
    vertex ids and edge records of the reference's SE2GraphBuilder
    (``edges`` are dicts: type, i, j, meas, info, level, kernel, delta)."""

    def __init__(self):
        self.poses = []
        self.fixed = []
        self.edges = []

    def add_vertex(self, pose, fixed=False) -> int:
        self.poses.append(np.asarray(pose, np.float64))
        self.fixed.append(bool(fixed))
        return len(self.poses) - 1

    def add_se2_edge(self, i, j, meas, info, level=0, kernel="NONE", delta=1.0):
        self.edges.append(dict(
            id=len(self.edges), type="se2", i=i, j=j,
            meas=np.asarray(meas, np.float64), info=np.asarray(info, np.float64),
            level=int(level), kernel=kernel, delta=float(delta),
        ))
        return len(self.edges) - 1


class DeltaBackend:
    def __init__(self, cfg: DeltaBackendConfig = DeltaBackendConfig(),
                 device="cpu"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.graph = PoseGraphLog()
        self.keyframe_updater = KeyframeUpdater(
            cfg.keyframe_delta_trans, cfg.keyframe_delta_angle
        )
        self.inf_calculator = cfg.inf
        self.timer = StageTimer()

        self.keyframes: List[KeyFrame] = []
        self.new_keyframes: List[KeyFrame] = []
        self.keyframe_queue: List[KeyFrame] = []

        th = np.deg2rad(cfg.init_angle_deg)
        self.trans_odom2map = np.array([cfg.init_x, cfg.init_y, th])
        self.anchor_node: Optional[int] = None
        self.anchor_edge_id: Optional[int] = None

    @property
    def poses(self):
        return np.stack(self.graph.poses) if self.graph.poses else np.zeros((0, 3))

    def cloud_callback(self, stamp, odom_4x4, cloud, flat_cloud, gt_pose=None):
        """Synchronized (odom, cloud, flat_cloud) arrival (:202-359), on the
        branch the reference takes when no building is near."""
        for c in (cloud, flat_cloud):
            if c.points.device != self.device:
                raise ValueError(
                    f"cloud on {c.points.device}, backend on {self.device}")
        odom2d = transform_3d_to_2d_np(odom_4x4)
        if not self.keyframe_updater.update(odom2d):
            # without a building alignment a non-keyframe changes nothing
            # (the initial-yaw bootstrap, :295-314, needs one)
            return
        self.keyframe_queue.append(KeyFrame(
            stamp=stamp, odom=np.asarray(odom_4x4), odom2d=odom2d,
            accum_distance=self.keyframe_updater.get_accum_distance(),
            cloud=cloud, flat_cloud=flat_cloud,
            estimated_odom=se2_compose_np(self.trans_odom2map, odom2d),
            gt_pose=None if gt_pose is None else np.asarray(gt_pose),
        ))

    def flush_keyframe_queue(self) -> bool:
        """Turn up to max_keyframes_per_update queued keyframes into graph
        vertices and odometry edges (:416-455)."""
        if not self.keyframe_queue:
            return False
        n = min(len(self.keyframe_queue), self.cfg.max_keyframes_per_update)
        batch = self.keyframe_queue[:n]
        del self.keyframe_queue[:n]
        odom2map = self.trans_odom2map
        pending = []   # (kf, prev, rel2d) awaiting the information matrices
        for i, kf in enumerate(batch):
            self.new_keyframes.append(kf)
            kf.node_id = self.graph.add_vertex(se2_compose_np(odom2map, kf.odom2d))
            if not self.keyframes and len(self.new_keyframes) == 1:
                self.anchor_node = self.graph.add_vertex(
                    odom2map, fixed=self.cfg.fix_first_node
                )
                self.anchor_edge_id = self.graph.add_se2_edge(
                    self.anchor_node, kf.node_id, np.zeros(3), np.eye(3)
                )
                continue
            prev = self.keyframes[-1] if i == 0 else batch[i - 1]
            # reversed measurement convention (:570-571)
            rel2d = se2_compose_np(se2_inverse_np(kf.odom2d), prev.odom2d)
            pending.append((kf, prev, rel2d))
        if pending:
            with self.timer.stage("information_matrix"):
                infos = self.inf_calculator.calc_information_matrices([
                    (kf.cloud, prev.cloud, np.linalg.inv(kf.odom) @ prev.odom)
                    for kf, prev, _ in pending
                ])
            for (kf, prev, rel2d), info in zip(pending, infos):
                self.graph.add_se2_edge(
                    kf.node_id, prev.node_id, rel2d, info, level=0,
                    kernel=self.cfg.odometry_edge_robust_kernel,
                    delta=self.cfg.odometry_edge_robust_kernel_size,
                )
        return True

    def optimization_step(self) -> dict:
        """The slice's part of the graph-update timer body (:793-927):
        flush the keyframe queue and commit the new keyframes (:746-747).
        Returns {} when the queue was empty. The graph solve and the GPS,
        building and loop updates come with later ports."""
        if not self.flush_keyframe_queue():
            return {}
        self.keyframes.extend(self.new_keyframes)
        self.new_keyframes = []
        return {"keyframes": len(self.keyframes), "edges": len(self.graph.edges)}
