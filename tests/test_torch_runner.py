"""The port's runtime against the JAX package, on the CPU: IMU deskew
(ops/cloud.py:deskew, the prefilter's deskew branch), the flow primitives
(pipeline/flow.py), the runner's IMU queue and msf prediction, the
threaded runner (pipeline/runner.py, threaded=True) and the process-wide
switches and timers its threads share.

The threaded drives run the delta preset at the small_delta_cfg scale
(raw 16384, out 4096, chunk 1024, keyframe gates 1.0 m / 1.0 rad, a 1 s
update interval) over 20 raycast frames without buildings.
"""

import dataclasses
import sys
import threading
import time

import numpy as np
import pytest
import torch

from delta_graph_slam_tpu import ops as R_ops
from delta_graph_slam_tpu.models.prefiltering import PrefilteringStage as RStage
from delta_graph_slam_tpu.pipeline import flow as r_flow
from delta_graph_slam_tpu.pipeline.runner import Pipeline as RPipeline
from delta_graph_slam_tpu_torch.buildings import StaticProvider
from delta_graph_slam_tpu_torch.config import get_preset
from delta_graph_slam_tpu_torch.geom.host import se2_compose_np, se2_inverse_np
from delta_graph_slam_tpu_torch.io.lidar_sim import raycast_city_sequence
from delta_graph_slam_tpu_torch.models.prefiltering import PrefilteringStage
from delta_graph_slam_tpu_torch.ops import cloud as p_cloud
from delta_graph_slam_tpu_torch.ops.segment import deterministic
from delta_graph_slam_tpu_torch.pipeline import flow as p_flow
from delta_graph_slam_tpu_torch.pipeline.runner import Pipeline
from delta_graph_slam_tpu_torch.utils.device import strict_fp32_matmul
from delta_graph_slam_tpu_torch.utils.profiling import StageTimer

from test_torch_register import _small as small_stages  # noqa: E402

torch.set_num_threads(2)

N_FRAMES = 20
EMPTY_OSM = "<osm></osm>"


def small_cfg(deskewing=False):
    cfg = get_preset("delta")
    pre, reg = small_stages(get_preset)
    pre = dataclasses.replace(pre, deskewing=deskewing)
    delta = dataclasses.replace(
        cfg.delta, keyframe_delta_trans=1.0, keyframe_delta_angle=1.0,
        graph_update_interval=1.0, compute_ate_rpe=True, solver_v_capacity=64,
        solver_e_capacity=256)
    return dataclasses.replace(cfg, prefiltering=pre, delta=delta,
                               odometry=dataclasses.replace(cfg.odometry, registration=reg))


@pytest.fixture(scope="module")
def frames():
    _, frames = raycast_city_sequence(n_frames=N_FRAMES, speed=3.0)
    return frames


# ------------------------------------------------------------------ deskew

def test_deskew_matches_reference():
    rng = np.random.default_rng(0)
    pts = rng.uniform(-30, 30, (4096, 3)).astype(np.float32)
    mask = rng.random(4096) > 0.2
    for w in ([0.0, 0.0, 2.0], [0.3, -0.5, 1.1], [0.0, 0.0, 0.0]):
        w = np.asarray(w, np.float32)
        want = R_ops.deskew(R_ops.make_cloud(pts, mask), w, 0.1)
        got = p_cloud.deskew(p_cloud.make_cloud(pts, mask), torch.from_numpy(w), 0.1)
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
        # float32 rotations of points within 52 m: within 2e-5 m
        np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points),
                                   rtol=0, atol=2e-5)
    # the last point of a scan turns by ~ w * scan_period: 0.2 rad here
    spun = p_cloud.deskew(p_cloud.make_cloud(np.tile([[10.0, 0, 0]], (100, 1))),
                          torch.tensor([0.0, 0.0, 2.0]), 0.1).points.numpy()
    assert abs(np.arctan2(spun[-1, 1], spun[-1, 0])) == pytest.approx(0.198, abs=2e-3)


def test_prefilter_deskew_matches_reference(frames):
    """PrefilteringStage.process(angular_velocity=...) with deskewing on:
    the same 3-D and 2-D outputs as the JAX stage, and not those of the
    scan left skewed."""
    pre, _ = small_stages(get_preset)
    pre = dataclasses.replace(pre, deskewing=True)
    from delta_graph_slam_tpu.config import get_preset as r_get_preset

    rpre = dataclasses.replace(small_stages(r_get_preset)[0], deskewing=True)
    ref, port = RStage(rpre), PrefilteringStage(pre, device="cpu")
    w = np.array([0.0, 0.0, 2.0], np.float32)
    pts = frames[0].points
    want = ref.process(pts, base_T=np.eye(4), angular_velocity=w)
    got = port.process(pts, base_T=np.eye(4), angular_velocity=w)
    for c_p, c_r in ((got.filtered3d, want.filtered3d), (got.filtered2d, want.filtered2d)):
        pm, rm = c_p.mask.numpy(), np.asarray(c_r.mask)
        np.testing.assert_array_equal(pm, rm)
        assert pm.sum() > 50
        np.testing.assert_allclose(c_p.points.numpy()[pm], np.asarray(c_r.points)[rm],
                                   rtol=0, atol=1e-5)       # 1e-5 m, as undeskewed
    plain = port.process(pts, base_T=np.eye(4))
    a = plain.filtered3d.points.numpy()[plain.filtered3d.mask.numpy()]
    b = got.filtered3d.points.numpy()[got.filtered3d.mask.numpy()]
    assert a.shape != b.shape or not np.allclose(a, b, atol=1e-4)


# -------------------------------------------------------------------- flow

@pytest.mark.parametrize("flow", [r_flow, p_flow], ids=["reference", "port"])
def test_bounded_queue(flow):
    """tests/test_io.py's case, on both packages' queue."""
    q = flow.BoundedQueue(maxlen=2)
    assert q.put(1, timeout=0.1)
    assert q.put(2, timeout=0.1)
    assert not q.put(3, timeout=0.05)  # full -> backpressure
    assert q.get() == 1
    assert q.put(3, timeout=0.1)
    q.close()
    assert q.get() == 2
    assert q.get() == 3
    assert q.get() is None
    assert not q.put(4, timeout=0.05)  # closed
    assert len(q) == 0


@pytest.mark.parametrize("flow", [r_flow, p_flow], ids=["reference", "port"])
def test_watermark(flow):
    """Consumers advertise progress; wait_until blocks until every one has
    passed the stamp (tests/test_io.py's player case, without the player)."""
    wm = flow.Watermark()
    assert wm.min_stamp() == float("inf") and wm.wait_until(5.0, timeout=0.01)
    wm.advertise("odometry", 1.0)
    wm.advertise("backend", 3.0)
    wm.advertise("backend", 2.0)                 # never moves back
    assert wm.min_stamp() == 1.0
    assert not wm.wait_until(2.0, timeout=0.05)
    t = threading.Timer(0.05, wm.advertise, ("odometry", 2.5))
    t.start()
    assert wm.wait_until(2.0, timeout=5.0)
    t.join(timeout=5.0)
    assert wm.min_stamp() == 2.5


def _imu_owner():
    """A bare object holding a runner's IMU queue, for _closest_imu."""
    owner = type("Owner", (), {})()
    owner._imu_queue, owner._imu_lock = [], threading.Lock()
    return owner


def test_closest_imu_matches_reference():
    """tests/test_pipeline_e2e.py's selection case on both packages' queues,
    then a longer stream: the same choices scan after scan."""
    r, p = _imu_owner(), _imu_owner()
    samples = [(0.05, [0, 0, 0.5]), (0.12, [0, 0, 1.0])]
    rng = np.random.default_rng(1)
    samples += [(0.2 + 0.013 * k, rng.normal(0, 1, 3)) for k in range(60)]
    for owner in (r, p):
        for stamp, w in samples[:2]:
            owner._imu_queue.append((stamp, np.asarray(w, np.float32)))
    for owner, cls in ((r, RPipeline), (p, Pipeline)):
        av = cls._closest_imu(owner, 0.11)
        assert av is not None and av[2] == pytest.approx(1.0)
        assert cls._closest_imu(owner, 5.0) is None     # nothing within 0.2 s
        assert cls._closest_imu(owner, 5.0) is None     # the queue survives misses
    for owner in (r, p):
        for stamp, w in samples[2:]:
            owner._imu_queue.append((stamp, np.asarray(w, np.float32)))
    for scan in np.arange(0.1, 1.4, 0.1):
        a, b = RPipeline._closest_imu(r, scan), Pipeline._closest_imu(p, scan)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
        assert len(r._imu_queue) == len(p._imu_queue)


def test_on_imu_feeds_the_deskew_queue(frames):
    """on_imu keeps angular velocities in a bounded queue; a scan without
    its own takes the closest one, and is deskewed by it."""
    pipe = Pipeline(small_cfg(deskewing=True), building_provider=StaticProvider(EMPTY_OSM),
                    device="cpu")
    for k in range(600):
        pipe.on_imu(0.01 * k, [1.0, 0.0, 0.0, 0.0], angular_velocity=[0.0, 0.0, 2.0])
    assert 256 <= len(pipe._imu_queue) <= 512
    got = pipe._stage_prefilter(5.0, frames[0].points)
    want = pipe.prefiltering.process(frames[0].points, angular_velocity=[0.0, 0.0, 2.0])
    assert torch.equal(got.filtered3d.points, want.filtered3d.points)


def test_msf_delta_seeds_the_odometry():
    pipe = Pipeline(small_cfg(), building_provider=StaticProvider(EMPTY_OSM), device="cpu")
    assert pipe._msf_delta() == (None, "")
    a, b = np.eye(4), np.eye(4)
    b[0, 3] = 0.3
    pipe.odometry.keyframe_stamp = 1.0
    pipe.on_msf_pose(1.05, a, after_update=True)
    pipe.on_msf_pose(1.1, b)
    delta, source = pipe._msf_delta()
    assert source == "imu"
    np.testing.assert_allclose(delta, b)
    pipe.odometry.keyframe_stamp = 1.05                  # too old (:160-162)
    assert pipe._msf_delta() == (None, "")


# ---------------------------------------------------------- threaded runner

def drive(frames, threaded, **kw):
    g0 = se2_inverse_np(frames[0].gt_pose)
    pipe = Pipeline(small_cfg(), building_provider=StaticProvider(EMPTY_OSM),
                    device="cpu", threaded=threaded, **kw)
    odo = []
    for fr in frames:
        pipe.on_gps(fr.stamp, *fr.gps)
        odo.append(pipe.on_points(fr.stamp, fr.points,
                                  gt_pose=se2_compose_np(g0, fr.gt_pose)))
    pipe.finish()
    return pipe, odo


@pytest.fixture(scope="module")
def serial(frames):
    return drive(frames, threaded=False)


def test_threaded_matches_serial(frames, serial):
    """The same keyframes, bit for bit (the front end runs one thread per
    stage in message order); the poses depend on when the optimizer fired,
    so they meet the ATE bound of tests/test_pipeline_e2e.py (0.1 m)."""
    pipe_s, odo_s = serial
    pipe_t, odo_t = drive(frames, threaded=True)
    assert all(o is None for o in odo_t)
    kf_s, kf_t = pipe_s.backend.keyframes, pipe_t.backend.keyframes
    assert len(kf_t) == len(kf_s) >= 4
    assert [k.stamp for k in kf_t] == [k.stamp for k in kf_s]
    for a, b in zip(kf_s, kf_t):
        assert np.array_equal(a.odom, b.odom)
        assert torch.equal(a.cloud.points, b.cloud.points)
    assert pipe_t.frames_processed == N_FRAMES
    # threaded, no stage clock waits for the card: it would take in the
    # other threads' queued work
    assert pipe_t.timer.sync is None and pipe_t.backend.timer.sync is None
    m = pipe_t.evaluate()
    assert m["ATE_mean"] < 0.1, m
    t = pipe_t.timing_summary()
    for stage in ("prefiltering", "odometry", "backend_enqueue"):
        assert t[stage]["count"] == N_FRAMES
    assert t["optimization_step"]["count"] >= 2
    assert not [th for th in pipe_t._stage_threads + [pipe_t._opt_thread] if th.is_alive()]
    # the switches the workers held are back as they were
    assert not torch.are_deterministic_algorithms_enabled()


def test_worker_error_surfaces_on_finish():
    pipe = Pipeline(small_cfg(), building_provider=StaticProvider(EMPTY_OSM),
                    device="cpu", threaded=True)
    pipe.on_gps(0.0, 49.0, 8.4)
    pipe.on_points(0.0, "not an array")          # breaks inside the worker
    deadline = time.monotonic() + 30
    while pipe._worker_error is None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pipe._worker_error is not None
    with pytest.raises(Exception):
        pipe.on_points(0.1, np.zeros((10, 3), np.float32))
    with pytest.raises(Exception):
        pipe.finish()
    assert not [th for th in pipe._stage_threads if th.is_alive()]


def test_backpressure_when_a_queue_is_full(frames):
    """With the prefilter held, a scan queue of 2 takes two scans and the
    third on_points blocks until the worker takes one."""
    pipe = Pipeline(small_cfg(), building_provider=StaticProvider(EMPTY_OSM),
                    device="cpu", threaded=True, scan_queue_size=2)
    gate = threading.Event()
    stage = pipe._stage_prefilter

    def held(*a):
        gate.wait(timeout=60)
        return stage(*a)

    pipe._stage_prefilter = held
    pipe.on_gps(frames[0].stamp, *frames[0].gps)
    sent = []

    def feed():
        for fr in frames[:4]:
            pipe.on_points(fr.stamp, fr.points)
            sent.append(fr.stamp)

    feeder = threading.Thread(target=feed, daemon=True)
    feeder.start()
    time.sleep(1.0)
    # the worker holds scan 0, the queue scans 1 and 2; scan 3 waits
    assert feeder.is_alive() and len(sent) == 3 and len(pipe._scan_queue) == 2
    gate.set()
    feeder.join(timeout=60)
    assert not feeder.is_alive() and len(sent) == 4
    pipe.finish()
    assert pipe.frames_processed == 4


# --------------------------------------------- switches and shared timers

@pytest.mark.parametrize("name", ["deterministic", "strict_fp32_matmul"])
def test_process_switch_holds_across_threads(name):
    """Two threads enter and leave in an overlapping order; each sees the
    setting inside, and it is restored only when both have left."""
    switch, read = {
        "deterministic": (deterministic, torch.are_deterministic_algorithms_enabled),
        "strict_fp32_matmul": (strict_fp32_matmul,
                               lambda: torch.get_float32_matmul_precision() == "highest"),
    }[name]
    before = (torch.are_deterministic_algorithms_enabled(),
              torch.get_float32_matmul_precision())
    torch.set_float32_matmul_precision("high")
    entered, first_left = threading.Barrier(2), threading.Event()
    seen = {}

    def first():
        with switch():
            entered.wait(timeout=10)
            seen["first"] = read()
        first_left.set()

    def second():
        with switch():
            entered.wait(timeout=10)
            first_left.wait(timeout=10)
            seen["second_after_first_left"] = read()

    try:
        ts = [threading.Thread(target=f) for f in (first, second)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=20)
        assert not any(t.is_alive() for t in ts)
        assert seen == {"first": True, "second_after_first_left": True}
        assert not read()                       # restored after the last
    finally:
        torch.set_float32_matmul_precision(before[1])
    assert torch.are_deterministic_algorithms_enabled() == before[0]


def test_shared_switch_and_timer_stress():
    """More threads than cores, a short switch interval: every thread sees
    the switch on inside, none loses a timer update, and the setting is
    restored at the end."""
    timer, errors = StageTimer(), []
    interval = sys.getswitchinterval()

    def work():
        for _ in range(200):
            with deterministic():
                if not torch.are_deterministic_algorithms_enabled():
                    errors.append("off inside")
                timer.add("stage", 1e-3)

    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work) for _ in range(16)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in ts)
    assert not errors
    assert timer.summary()["stage"]["count"] == 16 * 200
    assert not torch.are_deterministic_algorithms_enabled()
