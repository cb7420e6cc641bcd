"""The delta graph-SLAM backend: SE2 pose graph, GPS and loop closure.

Rebuild of DeltaGraphSlamNodelet (delta_graph_slam_nodelet.cpp) on the
port's modules: keyframe admission, odometry edges whose information comes
from the scan-match fitness, GPS priors, loop closure, and the two-level
robust LM through the direct chain solver (graph/solver.py ->
graph/chain_lm.py -> graph/chain_solve.py). ``optimization_step()`` is the
3 s wall-timer body (:793-927). The reference's quirks are kept: the
reversed odometry-edge measurement (:570-571), GPS-prior information
I / stddev (not / stddev^2), non-short-circuit update-source evaluation.

Not in this slice:
- OSM building constraints (align_global, building nodes, de-overlap) need
  the line-feature matcher of slice 3. A building in range raises; with
  ``enable_buildings`` off, or in a world without buildings, the backend
  follows the reference exactly.
- The threaded runner's four locks, the IMU initial orientation,
  save_map and save_state/load_state.

One divergence: the reference downloads OSM data from the public Overpass
server when no building provider is given. This backend needs the provider
named (``OverpassProvider(host)`` for that server, ``StaticProvider`` or
``FileProvider`` offline) and raises at the first GPS fix otherwise, so
nothing reaches the network unasked.
"""

import dataclasses
from typing import List, Optional

import numpy as np

from ..buildings.manager import BuildingManager
from ..geom.host import se2_compose_np, se2_inverse_np, transform_3d_to_2d_np
from ..geom.projection import gps_from_mercator, mercator_from_gps, mercator_scale
from ..graph import SE2GraphBuilder, SolverConfig, optimize_se2
from ..io.nmea import NmeaSentenceParser
from ..lines.align import LineScanmatcherConfig
from ..pipeline.information_matrix import InformationMatrixCalculator
from ..pipeline.keyframe import KeyFrame, KeyFrameSnapshot
from ..pipeline.keyframe_updater import KeyframeUpdater
from ..pipeline.loop_detector import LoopDetector
from ..register.config import RegistrationConfig
from ..register.engine import make_registration
from ..utils.device import resolve_device
from ..utils.profiling import StageTimer


@dataclasses.dataclass(frozen=True)
class DeltaBackendConfig:
    # graph
    max_keyframes_per_update: int = 10
    keyframe_delta_trans: float = 2.0
    keyframe_delta_angle: float = 2.0
    fix_first_node: bool = True
    g2o_solver_num_iterations: int = 512
    graph_update_interval: float = 3.0
    # table capacities of the solve (the graph grows past them; 0 = the
    # next capacity step of the live size)
    solver_v_capacity: int = 512
    solver_e_capacity: int = 2048
    # gps
    enable_gps_priors: bool = False
    gps_edge_stddev_xy: float = 1500.0
    gps_time_offset: float = 0.0
    gps_edge_robust_kernel: str = "NONE"
    gps_edge_robust_kernel_size: float = 1.0
    # loop closure
    distance_thresh: float = 15.0
    accum_distance_thresh: float = 25.0
    min_edge_interval: float = 15.0
    fitness_score_thresh: float = 2.5
    fitness_score_max_range: float = float("inf")
    loop_closure_edge_robust_kernel: str = "Huber"
    loop_closure_edge_robust_kernel_size: float = 1.0
    odometry_edge_robust_kernel: str = "NONE"
    odometry_edge_robust_kernel_size: float = 1.0
    building_edge_robust_kernel: str = "NONE"
    building_edge_robust_kernel_size: float = 1.0
    # buildings
    enable_buildings: bool = True
    nearby_buildings_radius: float = 35.0
    buffer_buildings_radius: float = 120.0
    overpass_host: str = "https://overpass-api.de"
    # init
    init_x: float = 0.0
    init_y: float = 0.0
    init_angle_deg: float = 0.0
    use_imu_for_initial_orientation: bool = False
    compute_ate_rpe: bool = False
    # sub-configs
    registration: RegistrationConfig = dataclasses.field(
        default_factory=lambda: RegistrationConfig(
            method="FAST_GICP", transformation_epsilon=0.1,
            maximum_iterations=64, max_correspondence_distance=2.0,
        )
    )
    # the line matcher's settings, read from slice 3 on
    scanmatcher: LineScanmatcherConfig = dataclasses.field(
        default_factory=lambda: LineScanmatcherConfig(
            min_cluster_size=40, cluster_tolerance=1.5,
            sac_distance_threshold=0.1, max_iterations=100,
            merror_threshold=0.1, line_length_threshold=1.5,
            g_avg_distance_weight=1.5, g_coverage_weight=0.5,
            g_transform_weight=0.5, g_max_score_distance=3.5,
            g_max_score_translation=3.5,
            l_avg_distance_weight=1.5, l_coverage_weight=1.5,
            l_transform_weight=0.1, l_max_score_distance=1.0,
            l_max_score_translation=3.5,
        )
    )
    # chain: direct BCR + Woodbury solve (graph/chain_solve.py); the delta
    # graph is a keyframe chain with few off-chain couplings
    solver: SolverConfig = dataclasses.field(
        default_factory=lambda: SolverConfig(backend="chain")
    )
    inf: InformationMatrixCalculator = dataclasses.field(
        default_factory=lambda: InformationMatrixCalculator(
            b_var_gain_a=7.0, b_max_stddev_x=2.0,
            b_avg_fitness_score=1.75,
            b_importance_ratio_global=500.0, b_importance_ratio_local=25.0,
        )
    )


def _slice3(what):
    return NotImplementedError(
        f"{what} needs the line-feature matcher, slice 3 of the port")


class DeltaBackend:
    def __init__(self, cfg: DeltaBackendConfig = DeltaBackendConfig(),
                 building_provider=None, device="cpu"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.graph = SE2GraphBuilder(device=self.device)
        self.keyframe_updater = KeyframeUpdater(
            cfg.keyframe_delta_trans, cfg.keyframe_delta_angle
        )
        self.registration = make_registration(cfg.registration)
        self.loop_detector = LoopDetector(
            self.registration,
            distance_thresh=cfg.distance_thresh,
            accum_distance_thresh=cfg.accum_distance_thresh,
            min_edge_interval=cfg.min_edge_interval,
            fitness_score_max_range=cfg.fitness_score_max_range,
            fitness_score_thresh=cfg.fitness_score_thresh,
        )
        self.inf_calculator = cfg.inf
        self.nmea_parser = NmeaSentenceParser()
        self.timer = StageTimer()

        self.keyframes: List[KeyFrame] = []
        self.new_keyframes: List[KeyFrame] = []
        self.keyframe_queue: List[KeyFrame] = []
        self.gps_queue: List[tuple] = []  # (stamp, lat, lon)
        self.snapshots: List[KeyFrameSnapshot] = []

        th = np.deg2rad(cfg.init_angle_deg)
        self.trans_odom2map = np.array([cfg.init_x, cfg.init_y, th])
        self.adjust_initial_orientation = not cfg.use_imu_for_initial_orientation

        self.origin: Optional[np.ndarray] = None
        self.scale: Optional[float] = None
        self.buildings_manager: Optional[BuildingManager] = None
        self._building_provider = building_provider

        self.anchor_node: Optional[int] = None
        self.anchor_edge_id: Optional[int] = None
        self.read_until_stamp = 0.0

    @property
    def poses(self):
        return np.stack(self.graph.poses) if self.graph.poses else np.zeros((0, 3))

    # ---------------------------------------------------------- gps path
    def gps_callback(self, stamp, lat, lon, alt=0.0):
        stamp = stamp + self.cfg.gps_time_offset
        if self.origin is None:
            if self._building_provider is None:
                raise ValueError(
                    "no building provider: pass OverpassProvider(host) to "
                    "query OSM online, or StaticProvider/FileProvider offline")
            self.scale = float(mercator_scale(lat))
            self.origin = np.asarray(mercator_from_gps(
                np.float64(lat), np.float64(lon), np.float64(alt),
                scale=self.scale))
            mgr = BuildingManager(
                self._building_provider, self.origin, self.scale,
                radius=self.cfg.nearby_buildings_radius,
                buffer_radius=self.cfg.buffer_buildings_radius,
            )
            self.gps_queue.append((stamp, lat, lon))
            mgr.get_buildings(lat, lon)
            self.buildings_manager = mgr   # publish once initialized
            return
        self.gps_queue.append((stamp, lat, lon))

    def nmea_callback(self, stamp, sentence):
        rmc = self.nmea_parser.parse(sentence)
        if rmc.valid:
            self.gps_callback(stamp, rmc.latitude, rmc.longitude, float("nan"))

    def navsat_callback(self, stamp, lat, lon, alt):
        self.gps_callback(stamp, lat, lon, alt)

    # ------------------------------------------------------ keyframe path
    def cloud_callback(self, stamp, odom_4x4, cloud, flat_cloud, gt_pose=None):
        """Synchronized (odom, cloud, flat_cloud) arrival (:202-359)."""
        mgr = self.buildings_manager
        if mgr is None:
            return  # :206-209, no GPS fix yet
        for c in (cloud, flat_cloud):
            if c.points.device != self.device:
                raise ValueError(f"cloud on {c.points.device}, backend on {self.device}")
        odom2d = transform_3d_to_2d_np(odom_4x4)
        add_keyframe = self.keyframe_updater.update(odom2d)
        if not add_keyframe and not self.adjust_initial_orientation:
            if not self.keyframe_queue:
                self.read_until_stamp = stamp + 3.0
            return

        map_pose = se2_compose_np(self.trans_odom2map, odom2d)
        # reverse-Mercator of the current estimated position (:243-251)
        xyz = np.array([map_pose[0], map_pose[1], 0.0]) + self.origin
        gps = gps_from_mercator(xyz, scale=self.scale)
        with self.timer.stage("get_buildings"):
            buildings = mgr.get_buildings(gps[0], gps[1])
        if buildings:
            raise _slice3("align_global against buildings in range")

        if add_keyframe:
            accum_d = self.keyframe_updater.get_accum_distance()
            if accum_d > 0:
                self.adjust_initial_orientation = False
            self.keyframe_queue.append(KeyFrame(
                stamp=stamp, odom=np.asarray(odom_4x4), odom2d=odom2d,
                accum_distance=accum_d, cloud=cloud, flat_cloud=flat_cloud,
                estimated_odom=map_pose.copy(), near_buildings=buildings,
                gt_pose=None if gt_pose is None else np.asarray(gt_pose),
            ))

    # --------------------------------------------------------- queue flush
    def flush_keyframe_queue(self) -> bool:
        """Up to max_keyframes_per_update queued keyframes become vertices
        and odometry edges (:416-455)."""
        if not self.keyframe_queue:
            return False
        n = min(len(self.keyframe_queue), self.cfg.max_keyframes_per_update)
        batch = self.keyframe_queue[:n]
        del self.keyframe_queue[:n]
        odom2map = self.trans_odom2map.copy()
        pending = []   # (kf, prev, rel2d) awaiting the information matrices
        for i, kf in enumerate(batch):
            self.new_keyframes.append(kf)
            kf.node_id = self.graph.add_vertex(se2_compose_np(odom2map, kf.odom2d))
            if not self.keyframes and len(self.new_keyframes) == 1:
                # the anchor is vertex 1: the first odometry edge (2, 0)
                # is then off-chain, as in the reference
                self.anchor_node = self.graph.add_vertex(
                    odom2map, fixed=self.cfg.fix_first_node)
                self.anchor_edge_id = self.graph.add_se2_edge(
                    self.anchor_node, kf.node_id, np.zeros(3), np.eye(3))
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

    def flush_gps_queue(self) -> bool:
        """Match GPS fixes to keyframes within 0.1 s; with GPS priors on,
        each match becomes a level-0 EdgeSE2PriorXY with information
        I / gps_edge_stddev_xy (the reference's quirk, :481-487)."""
        gps_queue = list(self.gps_queue)
        if not self.keyframes or not gps_queue:
            return False
        updated = False
        stamps = [g[0] for g in gps_queue]
        for kf in self.keyframes:
            if kf.stamp > stamps[-1]:
                break
            if kf.stamp < stamps[0] or kf.gps_coord is not None:
                continue
            dt = [abs(s - kf.stamp) for s in stamps]
            j = int(np.argmin(dt))
            if dt[j] > 0.1:
                continue
            _, lat, lon = gps_queue[j]
            xyz = np.asarray(mercator_from_gps(
                np.float64(lat), np.float64(lon), 0.0, scale=self.scale)) - self.origin
            gps_coord = xyz[:2]
            if not self.cfg.compute_ate_rpe:
                kf.gps_coord = gps_coord
            if self.cfg.enable_gps_priors:
                self.graph.add_prior_xy(
                    kf.node_id, gps_coord, np.eye(2) / self.cfg.gps_edge_stddev_xy,
                    level=0, kernel=self.cfg.gps_edge_robust_kernel,
                    delta=self.cfg.gps_edge_robust_kernel_size,
                )
                updated = True
        last = self.keyframes[-1].stamp
        self.gps_queue = [g for g in self.gps_queue if g[0] > last]
        return updated

    def update_building_nodes(self) -> bool:
        """Keyframe<->building constraints (delta:639-737). Without
        buildings near the new keyframes there is nothing to add."""
        if not self.cfg.enable_buildings or not self.new_keyframes:
            return False
        if any(kf.near_buildings for kf in self.new_keyframes):
            raise _slice3("keyframe<->building constraints")
        self.read_until_stamp = self.new_keyframes[-1].stamp + 3.0
        return False

    # --------------------------------------------------------- optimization
    def _optimize(self, level):
        vc = self.cfg.solver_v_capacity or None
        if vc:
            while vc < len(self.graph.poses):
                vc *= 2
        chain = self.cfg.solver.backend == "chain"
        with self.timer.stage("optimize_pack"):
            g = self.graph.to_arrays(
                v_capacity=vc, e_capacity=self.cfg.solver_e_capacity or None,
                chain_first=chain,
            )
        cfg = dataclasses.replace(
            self.cfg.solver,
            max_iterations=min(self.cfg.solver.max_iterations,
                               self.cfg.g2o_solver_num_iterations),
        )
        poses, stats = optimize_se2(
            g, level=level, config=cfg,
            off_hint=self.graph.count_offchain(level) if chain else None,
            n_chain=g.poses.shape[0] - 1 if chain else 0,
        )
        self.graph.update_poses(poses)
        return stats

    def optimization_step(self) -> dict:
        """The 3 s wall-timer body (:793-927). Returns stats, or {} when
        nothing changed."""
        stats = {}
        with self.timer.stage("kf_flush"):
            kf_updated = self.flush_keyframe_queue()
        if not kf_updated:
            self.read_until_stamp += 5.0
        gps_updated = self.flush_gps_queue()
        with self.timer.stage("building_nodes"):
            b_updated = self.update_building_nodes()
        if not (kf_updated | gps_updated | b_updated):
            return stats

        with self.timer.stage("loop_detection"):
            loops = self.loop_detector.detect(self.keyframes, self.new_keyframes,
                                              self.poses)
        for loop in loops:
            info = self.inf_calculator.calc_information_matrix(
                loop.key1.cloud, loop.key2.cloud, loop.relative_pose)
            self.graph.add_se2_edge(
                loop.key1.node_id, loop.key2.node_id, loop.relpose_2d, info,
                level=0, kernel=self.cfg.loop_closure_edge_robust_kernel,
                delta=self.cfg.loop_closure_edge_robust_kernel_size,
            )
        stats["loops"] = len(loops)

        self.keyframes.extend(self.new_keyframes)
        self.new_keyframes = []

        # two-phase optimization (:830-844)
        with self.timer.stage("optimize_level0"):
            for kf in self.keyframes:
                self.graph.set_fixed(kf.node_id, False)
            s0 = self._optimize(0)
        with self.timer.stage("optimize_level1"):
            for kf in self.keyframes:
                self.graph.set_fixed(kf.node_id, True)
            s1 = self._optimize(1)
        stats["chi2_level0"] = float(s0.chi2_final)
        stats["chi2_level1"] = float(s1.chi2_final)
        # the de-overlap loop (:846-899) runs over overlapping buildings;
        # without building nodes it has nothing to do
        stats["deoverlap_rounds"] = 0

        # odom->map update + snapshots (:905-916)
        poses = self.poses
        last = self.keyframes[-1]
        self.trans_odom2map = se2_compose_np(last.estimate(poses),
                                             se2_inverse_np(last.odom2d))
        with self.timer.stage("snapshots"):
            self.snapshots = [
                KeyFrameSnapshot(pose=kf.estimate(poses), cloud=kf.cloud,
                                 flat_cloud=kf.flat_cloud)
                for kf in self.keyframes
            ]
        return stats

    # ------------------------------------------------------------- export
    def dump_graph(self, destination) -> bool:
        """DumpGraph service equivalent: the g2o text graph + .kernels
        sidecar and the array checkpoint."""
        import os

        from ..graph.graph_io import save_g2o, save_npz

        os.makedirs(destination, exist_ok=True)
        save_g2o(self.graph, os.path.join(destination, "graph.g2o"))
        save_npz(self.graph, os.path.join(destination, "graph.npz"))
        return True

    def compute_ate_rpe(self):
        """ATE / t-RPE / r-RPE vs keyframe ground truth (:1204-1280)."""
        from ..utils.metrics import ate_rpe_se2

        poses = self.poses
        kfs = [k for k in self.keyframes if k.gt_pose is not None]
        return ate_rpe_se2([k.estimate(poses) for k in kfs],
                           [k.gt_pose for k in kfs])
