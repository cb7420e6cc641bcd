"""End-to-end pipeline runner (the nodelet-manager equivalent).

Wires PrefilteringStage -> ScanMatchingOdometry -> [FloorDetection] ->
backend (Delta SE2 or Hdl SE3) as the launch files wire the nodelets, on
one explicit device, with the backend's update step fired on the
graph_update_interval cadence of the message stamps (3 s for the hdl
backend).

Concurrency: ``threaded=True`` reproduces the nodelet manager's overlap
(concurrent nodelets and the 3 s optimization timer,
delta_graph_slam.launch:23-73, delta:793) as the JAX package's stage
pipeline: prefilter, odometry (+ floor detection) and the backend's
cloud callback each run on a worker of their own, joined by
BoundedQueues (the pub/sub hops), and an optimizer thread runs
``optimization_step`` whenever message time passes the update interval.
The default stays single-threaded.

On the card every thread enqueues on the one default stream, so queue
order is stream order: what a worker takes from a queue was enqueued
before anything it enqueues, no event is needed at a hand-off, and memory
freed by one thread is reused only by work enqueued after every use of
it. Per-worker streams were measured and bought nothing (the port is
host-bound: the threads contend for the interpreter, not the device), and
cuBLAS promises the same bits only while one stream is active. The stage
clocks do not wait for the card in threaded mode (``timer.sync`` and the
backend's are None): a wait there would wait for every thread's queued
work and serialize the threads it measures, so threaded stage means are
host latencies. Workers hold the process-wide deterministic-algorithm and
float32-precision switches for their whole life, so a front-end op sees
one setting whenever a solve starts or ends.

What repeats in threaded mode: the front end is one thread per stage in
message order, so keyframes and odometry are those of the serial run, bit
for bit. When the optimizer fires, and so which keyframes each update step
sees, depends on timing, as in the reference: the optimized poses, and
everything fed back from them (trans_odom2map, the delta backend's
estimated_odom and building alignments), vary from run to run.
"""

import threading
from typing import Optional

import numpy as np
import torch

from ..config.presets import PipelineConfig
from ..models.delta_backend import DeltaBackend
from ..models.floor_detection import FloorDetectionStage
from ..models.hdl_backend import HdlBackend
from ..models.prefiltering import PrefilteringStage
from ..models.scan_matching_odometry import ScanMatchingOdometry
from ..ops.segment import deterministic
from ..utils.device import DEFAULT_DEVICE, resolve_device, strict_fp32_matmul
from ..utils.profiling import StageTimer
from .flow import BoundedQueue, Watermark

# IMU samples kept for deskewing: past this many the oldest half goes
IMU_QUEUE_CAPACITY = 512


class Pipeline:
    def __init__(self, cfg: PipelineConfig, building_provider=None,
                 base_T: Optional[np.ndarray] = None, device=DEFAULT_DEVICE,
                 threaded: bool = False, scan_queue_size: int = 8):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.prefiltering = PrefilteringStage(cfg.prefiltering, self.device)
        self.odometry = ScanMatchingOdometry(cfg.odometry, self.device)
        self.floor = (FloorDetectionStage(cfg.floor, self.device)
                      if cfg.floor is not None else None)
        if cfg.delta is not None:
            self.backend = DeltaBackend(cfg.delta, building_provider, self.device)
            self._interval = cfg.delta.graph_update_interval
        else:
            self.backend = HdlBackend(cfg.hdl, self.device)
            self._interval = 3.0
        self.base_T = np.eye(4) if base_T is None else np.asarray(base_T)
        # stage clocks wait for the card, so each stage is charged its own
        # work; threaded, they wait for nothing (see the module docstring)
        self.timer = StageTimer(
            sync=torch.cuda.synchronize if self.device.type == "cuda" and not threaded
            else None)
        self._last_opt_stamp = None
        self.frames_processed = 0
        # read_until flow control (scan_matching_odometry:133-139,
        # delta:220-230): consumers advertise how far they have processed
        self.watermark = Watermark()
        self._imu_queue = []
        self._imu_lock = threading.Lock()
        self._msf_pose = self._msf_pose_after_update = None

        self.threaded = threaded
        self._worker_error = None
        self._stage_threads = []
        self._opt_thread = None
        if threaded:
            self.backend.timer.sync = None
            self._opt_due = threading.Event()
            self._stop = threading.Event()
            # three bounded queues = three pub/sub hops of the nodelet graph
            # (scan -> /filtered_points -> /odom -> backend)
            self._scan_queue = BoundedQueue(maxlen=scan_queue_size)
            self._odom_queue = BoundedQueue(maxlen=scan_queue_size)
            self._backend_queue = BoundedQueue(maxlen=scan_queue_size)
            for name, fn in (("prefilter_worker", self._prefilter_worker),
                             ("odometry_worker", self._odometry_worker),
                             ("backend_worker", self._backend_worker)):
                t = threading.Thread(target=self._run_worker, args=(fn,),
                                     name=name, daemon=True)
                t.start()
                self._stage_threads.append(t)
            self._opt_thread = threading.Thread(
                target=self._run_worker, args=(self._opt_worker,),
                name="optimizer", daemon=True)
            self._opt_thread.start()

    # ---- message entry points -----------------------------------------
    def on_gps(self, stamp, lat, lon, alt=0.0):
        self.backend.gps_callback(stamp, lat, lon, alt)

    def on_nmea(self, stamp, sentence):
        if hasattr(self.backend, "nmea_callback"):
            self.backend.nmea_callback(stamp, sentence)

    def on_imu(self, stamp, quat_wxyz, angular_velocity=None,
               linear_acceleration=None):
        """IMU message. ``angular_velocity`` goes into the bounded deskew
        queue, from which each scan takes the closest sample
        (prefiltering_nodelet.cpp:293-354). The delta backend takes its
        initial orientation from the first message; the hdl backend queues
        orientation and acceleration for its prior edges."""
        if angular_velocity is not None:
            with self._imu_lock:
                self._imu_queue.append(
                    (float(stamp), np.asarray(angular_velocity, np.float32)))
                if len(self._imu_queue) > IMU_QUEUE_CAPACITY:
                    del self._imu_queue[:IMU_QUEUE_CAPACITY // 2]
        if isinstance(self.backend, DeltaBackend):
            self.backend.imu_callback(quat_wxyz)
        else:
            self.backend.imu_callback(
                stamp, quat_wxyz,
                np.zeros(3) if linear_acceleration is None
                else linear_acceleration)

    def _closest_imu(self, stamp):
        """Angular velocity of the IMU sample closest to the scan stamp, or
        None when the queue is empty or nothing lies within 0.2 s. Samples
        before the scan are dropped, all but the last (the stream moves
        forward)."""
        with self._imu_lock:
            if not self._imu_queue:
                return None
            while len(self._imu_queue) > 1 and self._imu_queue[1][0] <= stamp:
                self._imu_queue.pop(0)
            best = min(self._imu_queue, key=lambda e: abs(e[0] - stamp))
        return best[1] if abs(best[0] - stamp) <= 0.2 else None

    def on_msf_pose(self, stamp, pose_4x4, after_update=False):
        """IMU-frontend (msf) pose for the odometry's initial guess
        (scan_matching_odometry:142-149, :190-198): the motion from the last
        after-update pose to the latest pose seeds the alignment."""
        if after_update:
            self._msf_pose_after_update = (stamp, np.asarray(pose_4x4))
        else:
            self._msf_pose = (stamp, np.asarray(pose_4x4))

    def _msf_delta(self):
        p0, p1 = self._msf_pose_after_update, self._msf_pose
        if p0 is None or p1 is None:
            return None, ""
        kf_stamp = self.odometry.keyframe_stamp
        if p0[0] <= kf_stamp or p1[0] <= kf_stamp:
            return None, ""     # msf data is too old (:160-162)
        return np.linalg.inv(p0[1]) @ p1[1], "imu"

    def on_points(self, stamp, points, gt_pose=None, angular_velocity=None):
        """Full per-scan path: prefilter -> odometry -> [floor] -> backend
        enqueue. Threaded, the scan is queued (a blocking put when the queue
        is full: backpressure, like the reference's subscriber queue) and
        None comes back; a worker's error is raised here or by finish()."""
        if self.threaded:
            if self._worker_error is not None:
                raise self._worker_error
            self._scan_queue.put((stamp, points, gt_pose, angular_velocity))
            return None
        out = self._stage_prefilter(stamp, points, angular_velocity)
        frame, coeffs = self._stage_odometry(stamp, out)
        self._stage_backend(stamp, out, frame, coeffs, gt_pose)
        return frame

    # ---- the three per-scan stages (one nodelet each in the reference) --
    def _stage_prefilter(self, stamp, points, angular_velocity=None):
        if angular_velocity is None and self.cfg.prefiltering.deskewing:
            angular_velocity = self._closest_imu(stamp)
        with self.timer.stage("prefiltering"):
            return self.prefiltering.process(
                points, base_T=self.base_T, angular_velocity=angular_velocity)

    def _stage_odometry(self, stamp, out):
        msf_delta, msf_source = self._msf_delta()
        with self.timer.stage("odometry"):
            frame = self.odometry.matching(stamp, out.filtered3d,
                                           msf_delta=msf_delta,
                                           msf_source=msf_source)
        coeffs = None
        if self.floor is not None and isinstance(self.backend, HdlBackend):
            with self.timer.stage("floor_detection"):
                coeffs = self.floor.detect(out.filtered3d)
        self.watermark.advertise("odometry", stamp + 1.0)
        return frame, coeffs

    def _stage_backend(self, stamp, out, frame, coeffs, gt_pose):
        hdl = isinstance(self.backend, HdlBackend)
        if hdl and self.floor is not None:
            self.backend.floor_coeffs_callback(stamp, coeffs)
        with self.timer.stage("backend_enqueue"):
            if hdl:
                self.backend.cloud_callback(
                    stamp, frame.pose, out.filtered3d, gt_pose=gt_pose)
            else:
                self.backend.cloud_callback(
                    stamp, frame.pose, out.filtered3d, out.filtered2d,
                    gt_pose=gt_pose)
        self.frames_processed += 1
        self.watermark.advertise(
            "backend", max(getattr(self.backend, "read_until_stamp", 0.0),
                           stamp + 3.0))
        # graph-update timer on message time
        if self._last_opt_stamp is None:
            self._last_opt_stamp = stamp
        if stamp - self._last_opt_stamp >= self._interval:
            if self.threaded:
                self._opt_due.set()     # the optimizer thread picks it up
            else:
                self.optimize()
            self._last_opt_stamp = stamp

    def optimize(self):
        with self.timer.stage("optimization_step"):
            return self.backend.optimization_step()

    # ---- threaded mode workers ------------------------------------------
    def _run_worker(self, body):
        """A worker's life, with the process-wide switches held throughout
        (see the module docstring)."""
        with deterministic(), strict_fp32_matmul():
            body()

    def _fail(self, e):
        self._worker_error = e
        for q in (self._scan_queue, self._odom_queue, self._backend_queue):
            q.close()

    def _stage_worker(self, inbox, work, outbox=None):
        """Take items from ``inbox`` until it is closed and drained; an
        error closes every queue and surfaces on finish()."""
        while True:
            item = inbox.get()
            if item is None:
                return
            try:
                out = work(*item)
                if outbox is not None:
                    outbox.put(out)
            except Exception as e:  # noqa: BLE001 - surfaced by finish()
                self._fail(e)
                return

    def _prefilter_worker(self):
        self._stage_worker(
            self._scan_queue,
            lambda stamp, points, gt_pose, angv: (
                stamp, self._stage_prefilter(stamp, points, angv), gt_pose),
            self._odom_queue)

    def _odometry_worker(self):
        self._stage_worker(
            self._odom_queue,
            lambda stamp, out, gt_pose: (
                stamp, out, *self._stage_odometry(stamp, out), gt_pose),
            self._backend_queue)

    def _backend_worker(self):
        self._stage_worker(self._backend_queue, self._stage_backend)

    def _opt_worker(self):
        while not self._stop.is_set():
            if not self._opt_due.wait(timeout=0.2):
                continue
            self._opt_due.clear()
            try:
                self.optimize()
            except Exception as e:  # noqa: BLE001 - surfaced by finish()
                self._worker_error = e
                return

    # ---- finishing -----------------------------------------------------
    def finish(self):
        """Drain the queues, then a final optimization: at least one update
        step and up to ten, until one changes nothing and the keyframe
        queue is empty. Threaded, each hop is closed and its worker joined in
        turn (a worker finishes its backlog first), then the optimizer
        thread; a worker's error is raised here."""
        if self.threaded:
            for q, t in zip((self._scan_queue, self._odom_queue, self._backend_queue),
                            self._stage_threads):
                q.close()
                t.join()
            self._stop.set()
            self._opt_thread.join()
            if self._worker_error is not None:
                raise self._worker_error
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
