"""The delta graph-SLAM backend (SE2 pose graph + buildings).

Rebuild of DeltaGraphSlamNodelet (delta_graph_slam_nodelet.cpp) on the
port's modules: keyframe admission, OSM building constraints through the
line-feature scan matcher, odometry edges whose information comes from the
scan-match fitness, GPS priors, loop closure, the three-level robust LM
through the direct chain solver (graph/solver.py -> graph/chain_lm.py ->
graph/chain_solve.py), building de-overlap and map export.
``optimization_step()`` is the 3 s wall-timer body (:793-927). The
reference's quirks are kept: the reversed odometry-edge measurement
(:570-571), GPS-prior information I / stddev (not / stddev^2),
non-short-circuit update-source evaluation (:811), the coverage (not
percentage) gate at 35 for the global-alignment priors (:714).

Host reads of device results: one per align_global (transform and
fitness), one per cycle for the batched align_local results, and per
de-overlap round one for the overlap flags and one for the alignments.
Batched pair and building counts are not padded: the JAX package pads them
to powers of two so that XLA reuses compiled programs, and padded slots
change no result.

Threads: the reference's four-mutex shape (delta_graph_slam_nodelet.cpp
:1316-1355). The graph, keyframes and snapshots sit behind the main lock,
which ``optimization_step`` holds; each message queue and trans_odom2map
sit behind a small lock of their own. The expensive per-keyframe work of
``cloud_callback`` (get_buildings, align_global) takes no lock the
optimizer holds, so the threaded runner's backend worker and optimizer
thread overlap (pipeline/runner.py). Time spent waiting for a lock is
recorded as ``lock_wait.<entry point>``.

Not in this slice: save_state/load_state and create_marker_array.

One divergence: the reference downloads OSM data from the public Overpass
server when no building provider is given. This backend needs the provider
named (``OverpassProvider(host)`` for that server, ``StaticProvider`` or
``FileProvider`` offline) and raises at the first GPS fix otherwise, so
nothing reaches the network unasked.
"""

import dataclasses
import functools
import os
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..buildings.manager import BuildingManager
from ..geom.host import (
    quat_to_rot_np, se2_compose_np, se2_inverse_np, transform_2d_to_3d_np,
    transform_3d_to_2d_np, yaw_from_rot_np,
)
from ..geom.projection import gps_from_mercator, mercator_from_gps, mercator_scale
from ..graph import SE2GraphBuilder, SolverConfig, optimize_se2
from ..io.nmea import NmeaSentenceParser
from ..io.pcd import save_pcd
from ..lines.align import LineBasedScanmatcher, LineScanmatcherConfig
from ..lines.features import make_lines, rot2, transform_lines
from ..lines.overlap import are_buildings_overlapped
from ..lines.scoring import FitnessScore
from ..ops.ransac import LineSegments
from ..pipeline.information_matrix import InformationMatrixCalculator
from ..pipeline.keyframe import KeyFrame, KeyFrameSnapshot
from ..pipeline.keyframe_updater import KeyframeUpdater
from ..pipeline.loop_detector import LoopDetector
from ..pipeline.map_cloud_generator import MapCloudGenerator
from ..register.config import RegistrationConfig
from ..register.engine import make_registration
from ..utils.device import DEFAULT_DEVICE, resolve_device
from ..utils.profiling import StageTimer


def _pair_map_lines(ba, bb, bm, bpose, est, ii, jj):
    """Map-frame building outlines for P (i, j) pairs.

    ba/bb (B, L, 2) raw download-frame endpoints, bm (B, L) masks,
    bpose (B, 3) fixed OSM poses, est (B, 3) current graph estimates,
    ii/jj (P,) pair indices. Re-poses every building by
    building_map_transform (rotation about the building center,
    building.cpp:7-13) and gathers the pair tensors."""
    R = rot2(est[:, 2] - bpose[:, 2])
    t = est[:, :2] - torch.einsum("bij,bj->bi", R, bpose[:, :2])
    ta = torch.einsum("bij,blj->bli", R, ba) + t[:, None, :]
    tb = torch.einsum("bij,blj->bli", R, bb) + t[:, None, :]
    return (ta[ii], tb[ii], bm[ii], est[ii][:, :2],
            ta[jj], tb[jj], bm[jj], est[jj][:, :2])


def _line_stack_of(a, b, mask):
    """Batched LineSegments from endpoint tensors (stats zero: building
    outlines carry no RANSAC fit stats)."""
    z = torch.zeros(mask.shape, dtype=a.dtype, device=a.device)
    return LineSegments(a=a, b=b, mean_error=z, std_sigma=z, max_error=z,
                        min_error=z, mask=mask)


def _host_alignment(result):
    """A global alignment with its transform (4,4) and fitness moved to the
    host in one read; the line sets stay on the device."""
    flat = torch.cat([result.transformation.reshape(-1),
                      torch.stack(list(result.fitness))]).cpu().numpy()
    return result._replace(transformation=flat[:16].reshape(4, 4),
                           fitness=FitnessScore(*(float(x) for x in flat[16:])))


def _concat_lines(buildings, capacity):
    """The buildings' raw outline segments as one masked batch on the host,
    from the corner polygons (b.lines was built from exactly
    corners[:-1] -> corners[1:], buildings/manager.py _new_building)."""
    a_all, b_all = [], []
    for bd in buildings:
        pts = np.asarray(bd.corners, np.float32)
        if len(pts) >= 2:
            a_all.append(pts[:-1])
            b_all.append(pts[1:])
    if not a_all:
        return make_lines(np.zeros((0, 2)), np.zeros((0, 2)), capacity=capacity)
    a = np.concatenate(a_all)[:capacity]
    b = np.concatenate(b_all)[:capacity]
    return make_lines(a, b, capacity=capacity)


def _locked(fn, attr="lock"):
    """Serialize an entry point on the named backend lock; waits longer than
    0.1 ms are recorded as ``lock_wait.<name>``, so stage means separate
    real work from cross-thread serialization."""

    @functools.wraps(fn)
    def wrapper(self, *a, **kw):
        t0 = time.perf_counter()
        with getattr(self, attr):
            dt = time.perf_counter() - t0
            if dt > 1e-4:
                self.timer.add("lock_wait." + fn.__name__, dt)
            return fn(self, *a, **kw)

    return wrapper


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


class DeltaBackend:
    def __init__(self, cfg: DeltaBackendConfig = DeltaBackendConfig(),
                 building_provider=None, device=DEFAULT_DEVICE):
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
        self.scanmatcher = LineBasedScanmatcher(cfg.scanmatcher, self.device)
        self.inf_calculator = cfg.inf
        self.map_generator = MapCloudGenerator()
        self.nmea_parser = NmeaSentenceParser()
        # stage clocks wait for the card, so each stage is charged its own
        # work (the threaded runner turns the wait off)
        self.timer = StageTimer(
            sync=torch.cuda.synchronize if self.device.type == "cuda" else None)

        self.keyframes: List[KeyFrame] = []
        self.new_keyframes: List[KeyFrame] = []
        self.keyframe_queue: List[KeyFrame] = []
        self.gps_queue: List[tuple] = []  # (stamp, lat, lon)
        self.snapshots: List[KeyFrameSnapshot] = []

        th = np.deg2rad(cfg.init_angle_deg)
        self.trans_odom2map = np.array([cfg.init_x, cfg.init_y, th])
        self.adjust_initial_orientation = not cfg.use_imu_for_initial_orientation
        self.initial_orientation_yaw = 0.0
        self._imu_seen = False

        self.origin: Optional[np.ndarray] = None
        self.scale: Optional[float] = None
        self.buildings_manager: Optional[BuildingManager] = None
        self._building_provider = building_provider
        self._bstack = None   # (building count, device outline stack)

        self.anchor_node: Optional[int] = None
        self.anchor_edge_id: Optional[int] = None
        self.overlap_edge_ids: List[int] = []
        self.read_until_stamp = 0.0
        self.lock = threading.RLock()            # main_thread_mutex
        self.kf_queue_lock = threading.Lock()    # keyframe_queue_mutex
        self.gps_queue_lock = threading.Lock()   # gps_queue_mutex
        self.odom2map_lock = threading.Lock()    # trans_odom2map_mutex

    @property
    def poses(self):
        return np.stack(self.graph.poses) if self.graph.poses else np.zeros((0, 3))

    # ---------------------------------------------------------- gps path
    # graph mutations on behalf of the building manager: a new building's
    # vertex and its weak level-1 priors (building_tools.cpp:137-148). They
    # come from the cloud_callback thread while the optimizer may hold the
    # graph, so they take the main lock (the reference mutates g2o there
    # unguarded; the JAX package closes that race the same way)
    def _graph_add_vertex(self, pose):
        with self.lock:
            return self.graph.add_vertex(pose)

    def _graph_add_prior_xy(self, v, xy, w):
        with self.lock:
            return self.graph.add_prior_xy(v, xy, np.eye(2) * w, level=1)

    def _graph_add_prior_yaw(self, v, yaw, w):
        with self.lock:
            return self.graph.add_prior_yaw(v, yaw, w, level=1)

    def gps_callback(self, stamp, lat, lon, alt=0.0):
        stamp = stamp + self.cfg.gps_time_offset
        with self.gps_queue_lock:
            first = self.origin is None
            if first:
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
                    graph_add_vertex=self._graph_add_vertex,
                    graph_add_prior_xy=self._graph_add_prior_xy,
                    graph_add_prior_yaw=self._graph_add_prior_yaw,
                    radius=self.cfg.nearby_buildings_radius,
                    buffer_radius=self.cfg.buffer_buildings_radius,
                    device=self.device,
                )
            self.gps_queue.append((stamp, lat, lon))
        if first:
            mgr.get_buildings(lat, lon)
            self.buildings_manager = mgr   # publish once initialized

    def nmea_callback(self, stamp, sentence):
        rmc = self.nmea_parser.parse(sentence)
        if rmc.valid:
            self.gps_callback(stamp, rmc.latitude, rmc.longitude, float("nan"))

    def navsat_callback(self, stamp, lat, lon, alt):
        self.gps_callback(stamp, lat, lon, alt)

    def imu_callback(self, quat_wxyz):
        """The first IMU message fixes the initial orientation (:388-421)."""
        if self._imu_seen:
            return
        self._imu_seen = True
        q = np.asarray(quat_wxyz, float)
        yaw = float(yaw_from_rot_np(quat_to_rot_np(q / np.linalg.norm(q))))
        self.initial_orientation_yaw = yaw
        if self.cfg.use_imu_for_initial_orientation:
            rot = np.array([0.0, 0.0, yaw])
            with self.odom2map_lock:
                self.trans_odom2map = se2_compose_np(rot, self.trans_odom2map)
            self._update_anchor(rot)

    def _update_anchor(self, pose):
        with self.lock:
            if self.anchor_node is not None and self.keyframes:
                self.graph.set_pose(self.anchor_node, pose)

    def _get_odom2map(self):
        with self.odom2map_lock:
            return self.trans_odom2map.copy()

    # ------------------------------------------------------ keyframe path
    def cloud_callback(self, stamp, odom_4x4, cloud, flat_cloud, gt_pose=None):
        """Synchronized (odom, cloud, flat_cloud) arrival (:202-359).

        Takes no lock the optimizer holds on its expensive path (as the
        reference computes align_global before taking keyframe_queue_mutex,
        :278, :344-358). One caller thread at a time: the keyframe updater
        is shared with no other entry point."""
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

        odom2map = self._get_odom2map()
        map_pose = se2_compose_np(odom2map, odom2d)
        # reverse-Mercator of the current estimated position (:243-251)
        xyz = np.array([map_pose[0], map_pose[1], 0.0]) + self.origin
        gps = gps_from_mercator(xyz, scale=self.scale)
        with self.timer.stage("get_buildings"):
            buildings = mgr.get_buildings(gps[0], gps[1])

        estimated_odom = map_pose.copy()
        result = None
        if buildings:
            with self.timer.stage("align_global"):
                # building lines into the sensor frame (:274-276), on the
                # host: the matcher merges them there before the upload
                blines = _concat_lines(buildings,
                                       capacity=self.cfg.scanmatcher.max_target_lines)
                inv3d = transform_2d_to_3d_np(se2_inverse_np(map_pose))
                result = _host_alignment(self.scanmatcher.align_global(
                    flat_cloud, transform_lines(blines, inv3d),
                    constrain_angle=add_keyframe, max_range=3.5,
                ))
            odom_trans2d = transform_3d_to_2d_np(result.transformation)
            estimated_odom = se2_compose_np(map_pose, odom_trans2d)

            # initial-yaw bootstrap between 1st and 2nd keyframe (:295-314)
            if self.adjust_initial_orientation and not add_keyframe:
                trans = se2_compose_np(odom2map, odom_trans2d)
                trans[:2] = 0.0
                self._update_anchor(trans)
                with self.odom2map_lock:
                    self.trans_odom2map = trans

        if add_keyframe:
            accum_d = self.keyframe_updater.get_accum_distance()
            if accum_d > 0:
                self.adjust_initial_orientation = False
            kf = KeyFrame(
                stamp=stamp, odom=np.asarray(odom_4x4), odom2d=odom2d,
                accum_distance=accum_d, cloud=cloud, flat_cloud=flat_cloud,
                estimated_odom=estimated_odom, global_alignment=result,
                near_buildings=buildings,
                gt_pose=None if gt_pose is None else np.asarray(gt_pose),
            )
            with self.kf_queue_lock:
                self.keyframe_queue.append(kf)

    # --------------------------------------------------------- queue flush
    def flush_keyframe_queue(self) -> bool:
        """Up to max_keyframes_per_update queued keyframes become vertices
        and odometry edges (:416-455)."""
        with self.kf_queue_lock:
            if not self.keyframe_queue:
                return False
            n = min(len(self.keyframe_queue), self.cfg.max_keyframes_per_update)
            batch = self.keyframe_queue[:n]
            del self.keyframe_queue[:n]
        odom2map = self._get_odom2map()
        pending = []   # (kf, prev, rel2d) awaiting the information matrices
        for i, kf in enumerate(batch):
            self.new_keyframes.append(kf)
            kf.node_id = self.graph.add_vertex(se2_compose_np(odom2map, kf.odom2d))
            if not self.keyframes and len(self.new_keyframes) == 1:
                # the anchor follows the first keyframe's vertex: the first
                # odometry edge then skips it and is off-chain, as in the
                # reference
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
        with self.gps_queue_lock:
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
        with self.gps_queue_lock:
            self.gps_queue = [g for g in self.gps_queue if g[0] > last]
        return updated

    # --------------------------------------------------- building updates
    def update_building_nodes(self) -> bool:
        """Per-cycle keyframe<->building constraints (delta:639-737).

        The reference's per-pair align_local loop (:687) runs as one
        batched alignment over every (new keyframe, near building) pair,
        with the frame transforms applied on the device and one read of
        the results.
        """
        if not self.cfg.enable_buildings or not self.new_keyframes:
            return False
        updated = False
        odom2map = self._get_odom2map()

        pairs = []
        for idx, kf in enumerate(self.new_keyframes):
            # skip the very first keyframe of the run (:652-656)
            if not self.keyframes and idx == 0:
                break
            if kf.global_alignment is None or not kf.near_buildings:
                continue
            odom = se2_compose_np(odom2map, kf.odom2d)
            odom3d = transform_2d_to_3d_np(odom)
            for b in kf.near_buildings:
                bpose_inv = np.linalg.inv(transform_2d_to_3d_np(b.pose))
                pairs.append((kf, b, odom, bpose_inv, bpose_inv @ odom3d))

        if pairs:
            P = len(pairs)
            # building side: gathered from the canonical outline stack by
            # pair index; keyframe side: the few unique keyframes' scan
            # lines stacked once and gathered per pair
            bs = list(self.buildings_manager.buildings)
            ba, bb, bm, _ = self._building_stack(bs)
            pos_of = {id(b): k for k, b in enumerate(bs)}
            kfs, kpos = [], {}
            for p in pairs:
                if id(p[0]) not in kpos:
                    kpos[id(p[0])] = len(kfs)
                    kfs.append(p[0])
            bidx = torch.as_tensor([pos_of[id(p[1])] for p in pairs], device=self.device)
            kidx = torch.as_tensor([kpos[id(p[0])] for p in pairs], device=self.device)
            ktree = LineSegments(*(torch.stack(f) for f in zip(
                *[k.global_alignment.not_aligned_lines for k in kfs])))
            Ts = np.stack([p[3] for p in pairs]).astype(np.float32)
            Tt = np.stack([p[4] for p in pairs]).astype(np.float32)
            with self.timer.stage("align_local"):
                src = _line_stack_of(ba[bidx], bb[bidx], bm[bidx])
                tgt = LineSegments(*(f[kidx] for f in ktree))
                res = self.scanmatcher.align_local_batch(src, tgt, Ts, Tt, 0.5)
                fit = res.fitness
                host = torch.cat([
                    res.transformation.reshape(P, 16), fit.avg_distance[:, None],
                    fit.coverage_percentage[:, None],
                    res.is_edge_aligned[:, None].to(fit.avg_distance.dtype),
                ], 1).cpu().numpy()
            T_all = host[:, :16].reshape(P, 4, 4)

            for k, (kf, b, odom, _, _) in enumerate(pairs):
                T = T_all[k]
                if np.allclose(T, np.eye(4), atol=1e-9):
                    continue
                info = self.inf_calculator.calc_information_matrix_buildings_local(
                    float(host[k, 16]), float(host[k, 17]), bool(host[k, 18])
                )
                trans2d = transform_3d_to_2d_np(T)
                # relpose keyframe -> (building.pose * trans) (:700-703)
                bt = se2_compose_np(b.pose, trans2d)
                relpose = se2_compose_np(se2_inverse_np(odom), bt)
                self.graph.add_se2_edge(
                    kf.node_id, b.node_id, relpose, info, level=1,
                    kernel=self.cfg.building_edge_robust_kernel,
                    delta=self.cfg.building_edge_robust_kernel_size,
                )
                updated = True

        # global-alignment position/yaw priors (:710-727)
        for idx, kf in enumerate(self.new_keyframes):
            if not self.keyframes and idx == 0:
                break
            if kf.global_alignment is None or not kf.near_buildings:
                continue
            ga = kf.global_alignment
            if ga.fitness.coverage < 35.0:
                continue
            info3 = self.inf_calculator.calc_information_matrix_buildings_global(
                ga.fitness.real_avg_distance)
            self.graph.add_prior_xy(
                kf.node_id, kf.estimated_odom[:2], info3[:2, :2], level=0,
                kernel=self.cfg.building_edge_robust_kernel,
                delta=self.cfg.building_edge_robust_kernel_size,
            )
            self.graph.add_prior_yaw(
                kf.node_id, kf.estimated_odom[2], info3[2, 2], level=0,
                kernel=self.cfg.building_edge_robust_kernel,
                delta=self.cfg.building_edge_robust_kernel_size,
            )
        self.read_until_stamp = self.new_keyframes[-1].stamp + 3.0
        return updated

    def get_overlapped_buildings(self):
        """All overlapping building pairs, tested in one batch."""
        bs, idx = self._overlapped_pairs()
        return [(bs[i], bs[j]) for i, j in idx]

    def _overlapped_pairs(self):
        """(buildings list, [(i, j) index pairs] of overlapped ones): every
        pair's shrunken-polygon test in one (P, La, Lb) batch, one read."""
        if self.buildings_manager is None:
            return [], []
        bs = list(self.buildings_manager.buildings)
        if len(bs) < 2:
            return bs, []
        pairs = [(i, j) for i in range(len(bs)) for j in range(i + 1, len(bs))]
        ov = are_buildings_overlapped(*self._pair_lines(bs, self.poses, pairs)).cpu().numpy()
        return bs, [p for p, o in zip(pairs, ov) if o]

    def _pair_lines(self, bs, poses, pairs):
        """_pair_map_lines of the (i, j) index pairs of buildings ``bs``."""
        ba, bb, bm, bp = self._building_stack(bs)
        est = torch.as_tensor(np.stack([b.estimate(poses) for b in bs]),
                              dtype=ba.dtype, device=self.device)
        ii = torch.as_tensor([p[0] for p in pairs], device=self.device)
        jj = torch.as_tensor([p[1] for p in pairs], device=self.device)
        return _pair_map_lines(ba, bb, bm, bp, est, ii, jj)

    def _building_stack(self, bs):
        """Canonical device stack of raw building outlines (download frame),
        rebuilt only when new buildings arrive. Returns (a (B,L,2),
        b (B,L,2), mask (B,L), poses (B,3)) float32 tensors."""
        if self._bstack is not None and self._bstack[0] == len(bs):
            return self._bstack[1]
        out = (torch.stack([b.lines.a for b in bs]), torch.stack([b.lines.b for b in bs]),
               torch.stack([b.lines.mask for b in bs]),
               torch.as_tensor(np.stack([b.pose for b in bs]), dtype=torch.float32,
                               device=self.device))
        self._bstack = (len(bs), out)
        return out

    def _deoverlap_round(self):
        """One round of the de-overlap loop (:846-899): returns False when
        no two buildings overlap; otherwise moves every overlapped pair
        apart with a level-2 edge and solves level 2."""
        with self.timer.stage("overlap_test"):
            bs, idx = self._overlapped_pairs()
        if not idx:
            return False
        pairs = [(bs[i], bs[j]) for i, j in idx]
        poses = self.poses
        with self.timer.stage("align_overlapped"):
            # one batched alignment for all overlapped pairs of the round
            # (the reference loops align_overlapped_buildings per pair,
            # delta:873-885)
            laa, lab, lam, _, lba, lbb, lbm, _ = self._pair_lines(bs, poses, idx)
            T_all, found = self.scanmatcher.align_overlapped_batch(
                _line_stack_of(laa, lab, lam), _line_stack_of(lba, lbb, lbm),
                np.stack([A.estimate(poses) for A, _ in pairs]),
                np.stack([Bb.estimate(poses) for _, Bb in pairs]))
            host = torch.cat([T_all.reshape(len(pairs), 16),
                              found[:, None].to(T_all.dtype)], 1).cpu().numpy()
        for k, (A, Bb) in enumerate(pairs):
            if not host[k, 16]:
                continue
            trans2d = transform_3d_to_2d_np(host[k, :16].reshape(4, 4).astype(np.float64))
            ta = se2_compose_np(trans2d, A.estimate(poses))
            relpose = se2_compose_np(se2_inverse_np(ta), Bb.estimate(poses))
            self.overlap_edge_ids.append(self.graph.add_se2_edge(
                A.node_id, Bb.node_id, relpose, np.eye(3) * 1e4, level=2,
                kernel=self.cfg.building_edge_robust_kernel,
                delta=self.cfg.building_edge_robust_kernel_size,
            ))
        with self.timer.stage("optimize_level2"):
            self._optimize(2)
        return True

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

    @_locked
    def optimization_step(self) -> dict:
        """The 3 s wall-timer body (:793-927), under the main lock. Returns
        stats, or {} when nothing changed."""
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

        # de-overlap loop (:846-899), at most 15 rounds; the previous
        # step's overlap edges go first
        for eid in self.overlap_edge_ids:
            self.graph.remove_edge(eid)
        self.overlap_edge_ids = []
        rounds = 0
        if self.cfg.enable_buildings:
            while rounds < 15 and self._deoverlap_round():
                rounds += 1
        stats["deoverlap_rounds"] = rounds

        # odom->map update + snapshots (:905-916)
        poses = self.poses
        last = self.keyframes[-1]
        with self.odom2map_lock:
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
    def save_map(self, destination, resolution=0.05) -> bool:
        """map.pcd (keyframe clouds at their optimized poses, occupied-voxel
        centers), b_map.pcd (the raw building outlines) and
        aligned_b_map.pcd (the outlines at the buildings' estimates),
        delta_graph_slam_nodelet.cpp:1181-1201."""
        os.makedirs(destination, exist_ok=True)
        cloud = self.map_generator.generate(self.snapshots, resolution)
        if cloud is None or not len(cloud):
            return False
        save_pcd(os.path.join(destination, "map.pcd"), cloud)
        if self.buildings_manager is not None:
            poses = self.poses
            raw, aligned = [], []
            for b in list(self.buildings_manager.buildings):
                raw.append(b.cloud.points[b.cloud.mask].cpu().numpy())
                ac = b.get_cloud(poses)
                aligned.append(ac.points[ac.mask].cpu().numpy())
            if raw:
                save_pcd(os.path.join(destination, "b_map.pcd"), np.concatenate(raw))
                save_pcd(os.path.join(destination, "aligned_b_map.pcd"),
                         np.concatenate(aligned))
        return True

    def dump_graph(self, destination) -> bool:
        """DumpGraph service equivalent: the g2o text graph + .kernels
        sidecar and the array checkpoint."""
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
