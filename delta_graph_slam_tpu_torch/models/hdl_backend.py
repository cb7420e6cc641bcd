"""SE3 graph-SLAM backend (hdl_graph_slam capability parity).

The delta fork drops HdlGraphSlamNodelet's source but keeps the capability
surface: SE3 vertices, floor-plane edges, IMU gravity/orientation edges,
GPS position priors, loop closure (the g2o types are registered at
graph_slam.cpp:36-47 and the hdl launch files wire the flags). This backend
rebuilds that pipeline on the SE3 solver:

- odometry edges       EdgeSE3 between consecutive keyframes
- floor edges          EdgeSE3Plane against one global floor plane vertex
- IMU acceleration     EdgeSE3PriorVec (gravity direction [0,0,1])
- IMU orientation      EdgeSE3PriorQuat
- GPS                  EdgeSE3PriorXY / PriorXYZ selected by stddev config
- loop closures        EdgeSE3 with robust kernel

The reference's quirks are kept: GPS and IMU informations divide by the
stddev, not its square, while the floor information divides by its square;
``flush_floor_queue`` clears the queue even of coefficients it matched to
no keyframe.

Threads: three locks, as in the JAX package (the reference nodelet's
fine-grained shape): the graph and keyframes behind the main lock, which
``optimization_step`` holds for its whole multi-second solve; the keyframe
queue and the floor / GPS / IMU queues behind small locks of their own, so
the message callbacks of the threaded runner never wait for a solve. The
JAX package ends ``flush_floor_queue`` by clearing the queue again outside
its lock, which would drop coefficients queued meanwhile by another
thread; that clear changes nothing single-threaded and is left out here.
"""

import dataclasses
import os
import threading
from typing import List, Optional

import numpy as np
import torch

from ..geom.host import quat_to_rot_np, transform_3d_to_2d_np, yaw_from_rot_np
from ..geom.projection import mercator_from_gps, mercator_scale
from ..graph import SE3GraphBuilder, SolverConfig, optimize_se3
from ..io.pcd import save_pcd
from ..pipeline.information_matrix import InformationMatrixCalculator
from ..pipeline.keyframe import KeyFrame, KeyFrameSnapshot
from ..pipeline.keyframe_updater import KeyframeUpdater
from ..pipeline.loop_detector import LoopDetector
from ..pipeline.map_cloud_generator import MapCloudGenerator
from ..register.config import RegistrationConfig
from ..register.engine import make_registration
from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..utils.profiling import StageTimer
from .delta_backend import _locked


@dataclasses.dataclass(frozen=True)
class HdlBackendConfig:
    max_keyframes_per_update: int = 10
    keyframe_delta_trans: float = 2.0
    keyframe_delta_angle: float = 2.0
    fix_first_node: bool = True
    fix_first_node_adaptive: bool = True
    g2o_solver_num_iterations: int = 512
    # capacity floors of the packed graph (doubled past these). The JAX
    # package needs them to reuse one compiled solver program across the 3 s
    # cycles; here they only fix the padded layout, and are kept so configs
    # carry across and both packages pack the same shapes
    solver_v_capacity: int = 256
    solver_e_capacity: int = 512
    solver_prior_capacity: int = 512
    solver_offrank_capacity: int = 64
    # floor
    enable_floor: bool = True
    floor_edge_stddev: float = 10.0
    floor_edge_robust_kernel: str = "NONE"
    floor_edge_robust_kernel_size: float = 1.0
    # imu
    enable_imu_acceleration: bool = False
    enable_imu_orientation: bool = False
    imu_acceleration_stddev: float = 3.0
    imu_orientation_stddev: float = 0.1
    imu_edge_robust_kernel: str = "NONE"
    imu_edge_robust_kernel_size: float = 1.0
    # gps
    enable_gps: bool = True
    gps_edge_stddev_xy: float = 10000.0
    gps_edge_stddev_z: float = 0.0        # >0 -> full xyz prior
    gps_time_offset: float = 0.0
    gps_edge_robust_kernel: str = "NONE"
    gps_edge_robust_kernel_size: float = 1.0
    # loop closure
    distance_thresh: float = 5.0
    accum_distance_thresh: float = 8.0
    min_edge_interval: float = 5.0
    fitness_score_thresh: float = 0.5
    loop_closure_edge_robust_kernel: str = "Huber"
    loop_closure_edge_robust_kernel_size: float = 1.0
    odometry_edge_robust_kernel: str = "NONE"
    odometry_edge_robust_kernel_size: float = 1.0
    registration: RegistrationConfig = dataclasses.field(
        default_factory=lambda: RegistrationConfig(method="NDT_OMP",
                                                   resolution=1.0)
    )
    # chain backend = direct BCR + hub elimination (graph/hub_solve.py): the
    # floor plane is a hub vertex every keyframe shares an edge with, which
    # edge-based Woodbury cannot absorb (K grows with the trajectory).
    # chi2_rel_tol 1e-6: the 3 s cycle re-solves a graph that is already at
    # (or a few keyframes away from) its optimum; without a relative-gain
    # exit the LM spends its whole budget accepting float-noise improvements
    solver: SolverConfig = dataclasses.field(
        default_factory=lambda: SolverConfig(backend="chain",
                                             chi2_rel_tol=1e-6))
    inf: InformationMatrixCalculator = dataclasses.field(
        default_factory=InformationMatrixCalculator
    )


class HdlBackend:
    def __init__(self, cfg: HdlBackendConfig = HdlBackendConfig(),
                 device=DEFAULT_DEVICE):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.graph = SE3GraphBuilder(device=self.device)
        self.keyframe_updater = KeyframeUpdater(
            cfg.keyframe_delta_trans, cfg.keyframe_delta_angle
        )
        self.registration = make_registration(cfg.registration)
        self.loop_detector = LoopDetector(
            self.registration,
            distance_thresh=cfg.distance_thresh,
            accum_distance_thresh=cfg.accum_distance_thresh,
            min_edge_interval=cfg.min_edge_interval,
            fitness_score_thresh=cfg.fitness_score_thresh,
        )
        self.inf_calculator = cfg.inf
        self.map_generator = MapCloudGenerator()
        # stage clocks wait for the card, so each stage is charged its own
        # work (the threaded runner turns the wait off)
        self.timer = StageTimer(
            sync=torch.cuda.synchronize if self.device.type == "cuda" else None)

        self.keyframes: List[KeyFrame] = []
        self.new_keyframes: List[KeyFrame] = []
        self.keyframe_queue: List[KeyFrame] = []
        self.floor_queue: List[tuple] = []   # (stamp, coeffs)
        self.gps_queue: List[tuple] = []     # (stamp, lat, lon, alt)
        self.imu_queue: List[tuple] = []     # (stamp, quat_wxyz, acc)
        self.snapshots: List[KeyFrameSnapshot] = []

        self.floor_plane_node: Optional[int] = None
        self.anchor_node: Optional[int] = None
        self.origin = None
        self.scale = None
        self.lock = threading.RLock()             # graph + keyframes
        self.kf_queue_lock = threading.Lock()     # keyframe_queue
        self.aux_queue_lock = threading.Lock()    # floor / gps / imu queues

    # ------------------------------------------------------------- inputs
    def cloud_callback(self, stamp, odom_4x4, cloud, gt_pose=None):
        """One caller thread at a time (the runner's backend worker): the
        keyframe updater is shared with no other entry point; only the
        queue push is cross-thread."""
        if cloud.points.device != self.device:
            raise ValueError(
                f"cloud on {cloud.points.device}, backend on {self.device}")
        odom = np.asarray(odom_4x4, float)
        odom2d = transform_3d_to_2d_np(odom)
        if not self.keyframe_updater.update(odom2d):
            return
        kf = KeyFrame(
            stamp=stamp, odom=odom, odom2d=odom2d,
            accum_distance=self.keyframe_updater.get_accum_distance(),
            cloud=cloud, flat_cloud=None,
            gt_pose=None if gt_pose is None else np.asarray(gt_pose),
        )
        with self.kf_queue_lock:
            self.keyframe_queue.append(kf)

    def floor_coeffs_callback(self, stamp, coeffs):
        if coeffs is not None:
            with self.aux_queue_lock:
                self.floor_queue.append((stamp, np.asarray(coeffs, float)))

    def gps_callback(self, stamp, lat, lon, alt=0.0):
        with self.aux_queue_lock:
            if self.origin is None:
                self.scale = float(mercator_scale(lat))
                self.origin = np.asarray(
                    mercator_from_gps(np.float64(lat), np.float64(lon),
                                      np.float64(alt), scale=self.scale)
                )
            self.gps_queue.append((stamp + self.cfg.gps_time_offset, lat, lon, alt))

    def imu_callback(self, stamp, quat_wxyz, linear_acceleration):
        with self.aux_queue_lock:
            self.imu_queue.append(
                (stamp, np.asarray(quat_wxyz, float),
                 np.asarray(linear_acceleration, float))
            )

    # ----------------------------------------------------------- flushing
    def flush_keyframe_queue(self) -> bool:
        with self.kf_queue_lock:
            if not self.keyframe_queue:
                return False
            n = min(len(self.keyframe_queue), self.cfg.max_keyframes_per_update)
            batch = self.keyframe_queue[:n]
            del self.keyframe_queue[:n]
        pending = []
        for i in range(n):
            kf = batch[i]
            self.new_keyframes.append(kf)
            kf.node_id = self.graph.add_se3_node(kf.odom)
            if not self.keyframes and len(self.new_keyframes) == 1:
                if self.cfg.fix_first_node:
                    self.anchor_node = self.graph.add_se3_node(
                        np.eye(4), fixed=True
                    )
                    self.graph.add_se3_edge(
                        self.anchor_node, kf.node_id, np.eye(4), np.eye(6)
                    )
                continue
            prev = self.keyframes[-1] if i == 0 else batch[i - 1]
            rel = np.linalg.inv(prev.odom) @ kf.odom
            pending.append((kf, prev, rel))
        if pending:
            infos = self.inf_calculator.calc_information_matrices_se3([
                (prev.cloud, kf.cloud, np.linalg.inv(rel))
                for kf, prev, rel in pending
            ])
            for (kf, prev, rel), info in zip(pending, infos):
                self.graph.add_se3_edge(
                    prev.node_id, kf.node_id, rel, info,
                    kernel=self.cfg.odometry_edge_robust_kernel,
                    delta=self.cfg.odometry_edge_robust_kernel_size,
                )
        return True

    def flush_floor_queue(self) -> bool:
        with self.aux_queue_lock:
            floor_queue, self.floor_queue = self.floor_queue, []
        if not self.cfg.enable_floor or not floor_queue:
            return False
        if not (self.keyframes or self.new_keyframes):
            # keep for the next cycle (the reference leaves unmatched coeffs
            # queued until keyframes exist)
            with self.aux_queue_lock:
                self.floor_queue = floor_queue + self.floor_queue
            return False
        updated = False
        allk = self.keyframes + self.new_keyframes
        for stamp, coeffs in floor_queue:
            # closest keyframe within 0.1 s
            dt = [abs(k.stamp - stamp) for k in allk]
            j = int(np.argmin(dt))
            if dt[j] > 0.1:
                continue
            kf = allk[j]
            if self.floor_plane_node is None:
                self.floor_plane_node = self.graph.add_plane_node(
                    [0.0, 0.0, 1.0, 0.0]
                )
            info = np.eye(3) / (self.cfg.floor_edge_stddev**2)
            self.graph.add_se3_plane_edge(
                kf.node_id, self.floor_plane_node, coeffs, info,
                kernel=self.cfg.floor_edge_robust_kernel,
                delta=self.cfg.floor_edge_robust_kernel_size,
            )
            updated = True
        return updated

    def flush_gps_queue(self) -> bool:
        with self.aux_queue_lock:
            gps_queue = list(self.gps_queue)
        if not self.cfg.enable_gps or not gps_queue or not self.keyframes:
            return False
        updated = False
        stamps = [g[0] for g in gps_queue]
        for kf in self.keyframes:
            if kf.gps_coord is not None:
                continue
            dt = [abs(s - kf.stamp) for s in stamps]
            j = int(np.argmin(dt))
            if dt[j] > 0.2:
                continue
            _, lat, lon, alt = gps_queue[j]
            xyz = np.asarray(
                mercator_from_gps(np.float64(lat), np.float64(lon),
                                  np.float64(alt), scale=self.scale)
            ) - self.origin
            kf.gps_coord = xyz[:2]
            if self.cfg.gps_edge_stddev_z > 0:
                info = np.diag([
                    1.0 / self.cfg.gps_edge_stddev_xy,
                    1.0 / self.cfg.gps_edge_stddev_xy,
                    1.0 / self.cfg.gps_edge_stddev_z,
                ])
                self.graph.add_se3_prior_xyz_edge(
                    kf.node_id, xyz, info,
                    kernel=self.cfg.gps_edge_robust_kernel,
                    delta=self.cfg.gps_edge_robust_kernel_size,
                )
            else:
                info = np.eye(2) / self.cfg.gps_edge_stddev_xy
                self.graph.add_se3_prior_xy_edge(
                    kf.node_id, xyz[:2], info,
                    kernel=self.cfg.gps_edge_robust_kernel,
                    delta=self.cfg.gps_edge_robust_kernel_size,
                )
            updated = True
        last = self.keyframes[-1].stamp
        with self.aux_queue_lock:
            self.gps_queue = [g for g in self.gps_queue if g[0] > last]
        return updated

    def flush_imu_queue(self) -> bool:
        with self.aux_queue_lock:
            imu_queue = list(self.imu_queue)
        if not imu_queue or not self.keyframes:
            return False
        if not (self.cfg.enable_imu_acceleration or self.cfg.enable_imu_orientation):
            with self.aux_queue_lock:
                self.imu_queue = []
            return False
        updated = False
        stamps = [m[0] for m in imu_queue]
        for kf in self.keyframes:
            dt = [abs(s - kf.stamp) for s in stamps]
            j = int(np.argmin(dt))
            if dt[j] > 0.1:
                continue
            _, quat, acc = imu_queue[j]
            if self.cfg.enable_imu_orientation:
                info = np.eye(3) / self.cfg.imu_orientation_stddev
                self.graph.add_se3_prior_quat_edge(
                    kf.node_id, quat, info,
                    kernel=self.cfg.imu_edge_robust_kernel,
                    delta=self.cfg.imu_edge_robust_kernel_size,
                )
                updated = True
            if self.cfg.enable_imu_acceleration and np.linalg.norm(acc) > 1e-3:
                info = np.eye(3) / self.cfg.imu_acceleration_stddev
                self.graph.add_se3_prior_vec_edge(
                    kf.node_id, [0.0, 0.0, 1.0], acc, info,
                    kernel=self.cfg.imu_edge_robust_kernel,
                    delta=self.cfg.imu_edge_robust_kernel_size,
                )
                updated = True
        last = self.keyframes[-1].stamp
        with self.aux_queue_lock:
            self.imu_queue = [m for m in self.imu_queue if m[0] > last]
        return updated

    # --------------------------------------------------------- optimization
    @property
    def poses2d(self):
        """(V,3) SE2 projections of the SE3 keyframe estimates (for the
        shared loop detector). Host numpy, once a cycle."""
        if not self.graph.poses:
            return np.zeros((0, 3))
        P = np.stack(self.graph.poses).astype(np.float64)
        R = quat_to_rot_np(P[:, 3:7])
        out = np.zeros((len(P), 3))
        out[:, :2] = P[:, :2]
        for i in range(len(P)):
            out[i, 2] = yaw_from_rot_np(R[i])
        return out

    def compute_ate_rpe(self):
        """ATE / t-RPE / r-RPE vs keyframe ground truth
        (delta_graph_slam_nodelet.cpp:1204-1280). SE3 estimates are projected
        to SE2 to match the simulators' planar ground truth; the z/roll/pitch
        error is carried by the floor and IMU constraints and shows in the
        SE3 chi2."""
        from ..utils.metrics import ate_rpe_se2

        poses2d = self.poses2d
        kfs = [k for k in self.keyframes
               if k.gt_pose is not None and k.node_id is not None]
        return ate_rpe_se2([poses2d[k.node_id] for k in kfs],
                           [np.asarray(k.gt_pose, float) for k in kfs])

    @_locked
    def optimization_step(self) -> dict:
        """The 3 s timer body, under the main lock: flush the four queues,
        detect loops, solve. Returns stats, or {} when nothing changed."""
        stats = {}
        kf_updated = self.flush_keyframe_queue()
        floor_updated = self.flush_floor_queue()
        gps_updated = self.flush_gps_queue()
        imu_updated = self.flush_imu_queue()
        if not (kf_updated or floor_updated or gps_updated or imu_updated):
            return stats

        with self.timer.stage("loop_detection"):
            loops = self.loop_detector.detect(
                self.keyframes, self.new_keyframes, self.poses2d
            )
        for loop in loops:
            rel = loop.relative_pose
            info = self.inf_calculator.calc_information_matrix_se3(
                loop.key1.cloud, loop.key2.cloud, rel
            )
            self.graph.add_se3_edge(
                loop.key1.node_id, loop.key2.node_id, rel, info,
                kernel=self.cfg.loop_closure_edge_robust_kernel,
                delta=self.cfg.loop_closure_edge_robust_kernel_size,
            )
        stats["loops"] = len(loops)

        self.keyframes.extend(self.new_keyframes)
        self.new_keyframes = []

        with self.timer.stage("optimize_pack"):
            g = self.graph.to_arrays(
                v_capacity=self.cfg.solver_v_capacity or None,
                e_capacity=self.cfg.solver_e_capacity or None,
                prior_capacity=self.cfg.solver_prior_capacity or None,
            )
            cfg = dataclasses.replace(
                self.cfg.solver,
                max_iterations=min(self.cfg.solver.max_iterations,
                                   self.cfg.g2o_solver_num_iterations),
            )
        with self.timer.stage("optimize"):
            # warm start is implicit: graph.poses carries the previous
            # cycle's optimum (update_from below), as g2o's persistent
            # SparseOptimizer does across the 3 s timer cycles
            # (graph_slam.cpp:338-352); lm_core's dx-based termination makes
            # an already-converged cycle exit in O(1) iterations. The
            # off-chain count comes from the builder, so sizing the Woodbury
            # capacity reads nothing back from the device.
            (poses, planes, points), s = optimize_se3(
                g, level=0, config=cfg,
                offrank_floor=self.cfg.solver_offrank_capacity,
                n_offchain=self.graph.count_offchain(),
            )
        with self.timer.stage("optimize_fetch"):
            self.graph.update_from(poses, planes, points)
            stats["lm_iters"] = int(s.iterations)
            stats["chi2"] = float(s.chi2_final)

        poses2d = self.poses2d
        self.snapshots = [
            KeyFrameSnapshot(pose=poses2d[kf.node_id], cloud=kf.cloud)
            for kf in self.keyframes
        ]
        return stats

    def dump_graph(self, destination) -> bool:
        """DumpGraph service equivalent: g2o text SE3 graph + kernels."""
        from ..graph.graph_io import save_g2o_se3

        os.makedirs(destination, exist_ok=True)
        save_g2o_se3(self.graph, os.path.join(destination, "graph.g2o"))
        return True

    def save_map(self, destination, resolution=0.05) -> bool:
        os.makedirs(destination, exist_ok=True)
        cloud = self.map_generator.generate(self.snapshots, resolution)
        if cloud is None or not len(cloud):
            return False
        save_pcd(os.path.join(destination, "map.pcd"), cloud)
        return True
