"""The port's hdl path (plane RANSAC, floor detection, SE3 information
matrices, HdlBackend, the hdl presets, the runner's floor stage) against
the JAX package on the CPU, and the slice as a whole at the small sizes of
tests/test_pipeline_e2e.py:131-147.

The JAX package's own hdl drives are slow tests; a parity run of the drive
against the JAX pipeline is marked slow here too.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delta_graph_slam_tpu import ops as R_ops
from delta_graph_slam_tpu.config import get_preset as r_get_preset
from delta_graph_slam_tpu.models.floor_detection import (
    FloorDetectionConfig as RFloorConfig, FloorDetectionStage as RFloorStage,
)
from delta_graph_slam_tpu.models.hdl_backend import HdlBackend as RHdlBackend
from delta_graph_slam_tpu.models.hdl_backend import HdlBackendConfig as RHdlBackendConfig
from delta_graph_slam_tpu.ops import ransac as r_ransac
from delta_graph_slam_tpu.pipeline.information_matrix import (
    InformationMatrixCalculator as RInf,
)
from delta_graph_slam_tpu.pipeline.runner import Pipeline as RPipeline
from delta_graph_slam_tpu_torch.config import get_preset as p_get_preset
from delta_graph_slam_tpu_torch.geom.host import se2_compose_np, se2_inverse_np
from delta_graph_slam_tpu_torch.interop import config_from_reference_fields
from delta_graph_slam_tpu_torch.io.kitti import synthetic_city_sequence
from delta_graph_slam_tpu_torch.models.floor_detection import (
    FloorDetectionConfig, FloorDetectionStage,
)
from delta_graph_slam_tpu_torch.models.hdl_backend import HdlBackend, HdlBackendConfig
from delta_graph_slam_tpu_torch.ops import ransac as p_ransac
from delta_graph_slam_tpu_torch.ops.cloud import make_cloud, plane_clip
from delta_graph_slam_tpu_torch.pipeline.information_matrix import (
    InformationMatrixCalculator,
)
from delta_graph_slam_tpu_torch.pipeline.runner import Pipeline as PPipeline
from delta_graph_slam_tpu_torch.utils.device import strict_fp32_matmul

torch.set_num_threads(2)

HDL_PRESETS = ["hdl", "hdl_400", "hdl_501", "hdl_imu"]


def city_scan(n=4000, seed=0, sensor_height=1.8):
    """tests/test_models.py:18-29: a ground plane and one wall."""
    rng = np.random.default_rng(seed)
    ground = np.stack([rng.uniform(-40, 40, n // 2), rng.uniform(-40, 40, n // 2),
                       np.full(n // 2, -sensor_height)], 1)
    wall = np.stack([rng.uniform(-40, 40, n - n // 2), np.full(n - n // 2, 12.0),
                     rng.uniform(-sensor_height, 4.0, n - n // 2)], 1)
    return (np.concatenate([ground, wall]) + rng.normal(0, 0.01, (n, 3))).astype(np.float32)


class JaxFloorSampler:
    """The JAX floor stage's RANSAC stream as uniforms for the port
    (models/floor_detection.py:143-150, ops/ransac.py:32-35, :49)."""

    def __init__(self, seed=42):
        self.key = jax.random.PRNGKey(seed)

    def __call__(self, n_hypotheses):
        self.key, sub = jax.random.split(self.key)
        return np.array(jax.random.uniform(sub, (n_hypotheses, 3)))


# --------------------------------------------------- (h) plane clip, RANSAC

def test_plane_clip_matches_reference():
    pts = city_scan(n=600, seed=1)
    mask = np.random.default_rng(1).random(600) > 0.2
    for plane, negative in (([0.0, 0.0, 1.0, 2.8], False), ([0.0, 0.0, 1.0, 0.8], True),
                            ([0.3, -0.2, 0.9, 0.5], False)):
        got = plane_clip(make_cloud(pts, mask), plane, negative=negative)
        want = R_ops.plane_clip(R_ops.make_cloud(pts, mask=mask), jnp.asarray(plane),
                                negative=negative)
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
        np.testing.assert_array_equal(got.points.numpy(), np.asarray(want.points))


@pytest.mark.parametrize("seed", [0, 3])
def test_ransac_and_refine_plane_match_reference(seed):
    """The same points and the same injected uniforms: the same best
    hypothesis, equal inlier masks, coefficients within 1e-5."""
    rng = np.random.default_rng(seed)
    pts = city_scan(n=1500, seed=seed)
    pts = pts[pts[:, 2] < -0.8]                 # the clipped band, ragged
    mask = rng.random(len(pts)) > 0.15          # holes: valid is no prefix
    key = jax.random.PRNGKey(seed)
    u = np.array(jax.random.uniform(key, (128, 3)))
    rc = R_ops.make_cloud(pts, mask=mask, capacity=1024)
    pc = make_cloud(pts, mask, capacity=1024)
    want = r_ransac.ransac_plane(rc, key, n_hypotheses=128, dist_thresh=0.1,
                                 min_inliers=200)
    got = p_ransac.ransac_plane(pc, torch.from_numpy(u), dist_thresh=0.1,
                                min_inliers=200)
    assert bool(got.ok) == bool(want.ok) and bool(got.ok)
    assert int(got.n_inliers) == int(want.n_inliers)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    np.testing.assert_allclose(got.coeffs.numpy(), np.asarray(want.coeffs), atol=1e-5)
    refined = p_ransac.refine_plane(pc.points, got.inliers, got.coeffs)
    r_refined = r_ransac.refine_plane(rc.points, want.inliers, want.coeffs)
    np.testing.assert_allclose(refined.numpy(), np.asarray(r_refined), atol=1e-5)
    assert abs(float(refined[2])) > 0.99 and abs(float(refined[3]) - 1.8) < 0.05


def test_ransac_plane_degenerate_and_empty():
    """Collinear samples never win; an empty cloud is not ok and finite."""
    line = np.stack([np.linspace(0, 10, 64), np.zeros(64), np.zeros(64)], 1)
    u = torch.rand((32, 3), generator=torch.Generator().manual_seed(0))
    res = p_ransac.ransac_plane(make_cloud(line.astype(np.float32)), u, min_inliers=10)
    assert not bool(res.ok) or int(res.n_inliers) == 64
    empty = make_cloud(np.zeros((16, 3), np.float32), np.zeros(16, bool))
    res = p_ransac.ransac_plane(empty, u, min_inliers=1)
    assert not bool(res.ok) and int(res.n_inliers) == 0


# ------------------------------------------------------ (i) floor detection

@pytest.mark.parametrize("method", ["brute", "voxel"])
def test_floor_detection_matches_reference(method):
    """tests/test_models.py:114-126's scene, the JAX stream replayed: three
    frames, coefficients within 1e-4 of the JAX stage's."""
    kw = dict(sensor_height=1.8, height_clip_range=1.0, floor_pts_thresh=200,
              capacity=4096, chunk=512, n_hypotheses=256, neighbor_method=method)
    ref = RFloorStage(RFloorConfig(**kw))
    port = FloorDetectionStage(FloorDetectionConfig(**kw), device="cpu",
                               sampler=JaxFloorSampler())
    for seed in (4, 5, 6):
        scan = city_scan(n=3000, seed=seed)
        want, got = ref.detect(scan), port.detect(scan)
        assert want is not None and got is not None
        np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
        # floor at z = -1.8 in the sensor frame: n ~ +z, d ~ 1.8
        np.testing.assert_allclose(abs(got[2]), 1.0, atol=0.02)
        np.testing.assert_allclose(got[3], 1.8, atol=0.1)


def test_floor_detection_no_floor_and_tilt():
    """tests/test_models.py:128-139: a wall alone gives None in both; a
    tilted sensor's floor comes back in the untilted frame, as the JAX
    stage's (1e-4)."""
    kw = dict(sensor_height=1.8, floor_pts_thresh=200, capacity=2048, chunk=512)
    rng = np.random.default_rng(5)
    wall = np.stack([rng.uniform(-20, 20, 1500), np.full(1500, 8.0),
                     rng.uniform(-1.5, 3.0, 1500)], 1).astype(np.float32)
    assert RFloorStage(RFloorConfig(**kw)).detect(wall) is None
    assert FloorDetectionStage(FloorDetectionConfig(**kw), device="cpu",
                               sampler=JaxFloorSampler()).detect(wall) is None

    kw = dict(kw, tilt_deg=4.0, capacity=4096, n_hypotheses=128,
              use_normal_filtering=False)
    t = np.deg2rad(-4.0)
    Ry = np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0], [-np.sin(t), 0, np.cos(t)]],
                  np.float32)
    scan = city_scan(n=3000, seed=8) @ Ry.T      # the sensor pitched by 4 deg
    want = RFloorStage(RFloorConfig(**kw)).detect(scan)
    got = FloorDetectionStage(FloorDetectionConfig(**kw), device="cpu",
                              sampler=JaxFloorSampler()).detect(scan)
    assert want is not None and got is not None
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)
    assert abs(got[0]) > 0.05                    # the tilt shows in the normal


def test_floor_detection_default_sampler_repeats_and_dense_raises():
    cfg = FloorDetectionConfig(sensor_height=1.8, floor_pts_thresh=200, capacity=4096,
                               chunk=512, n_hypotheses=128)
    scan = city_scan(n=3000, seed=4)
    a = [FloorDetectionStage(cfg, device="cpu").detect(scan) for _ in range(2)]
    np.testing.assert_array_equal(a[0], a[1])
    # 'dense' neighbours are ported (tests/test_torch_moments.py holds them to
    # the reference); an unknown method raises
    with pytest.raises(ValueError, match="nope"):
        FloorDetectionStage(dataclasses.replace(cfg, neighbor_method="nope"),
                            device="cpu")
    # at this scan's density (1500 ground points over 80 x 80 m) no point has
    # the 3 neighbours within 0.75 m that a radius normal needs
    dense = FloorDetectionStage(dataclasses.replace(cfg, neighbor_method="dense"),
                                device="cpu").detect(scan)
    assert dense is None


def test_strict_fp32_matmul_restores_the_setting():
    before = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        with strict_fp32_matmul():
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(before)


# ---------------------------------------------- (j) SE3 information matrices

def test_information_matrix_se3_matches_reference():
    # two small clouds, within 2 m of the origin: both packages expand
    # |q - t|^2 = |q|^2 - 2 q.t + |t|^2 in float32, whose rounding grows with
    # |p|^2 (at a scan's 40 m the fitness already differs by 1e-3 relative)
    rng = np.random.default_rng(2)
    a = rng.uniform(-2, 2, (900, 3)).astype(np.float32)
    Tm = np.eye(4)
    Tm[:3, 3] = [0.05, -0.02, 0.01]
    for noise in (0.1, 0.2):
        b = (a - Tm[:3, 3] + rng.normal(0, noise, a.shape)).astype(np.float32)
        args_r = (R_ops.make_cloud(a, capacity=1024), R_ops.make_cloud(b, capacity=1024), Tm)
        args_p = (make_cloud(a, capacity=1024), make_cloud(b, capacity=1024), Tm)
        want = RInf().calc_information_matrix_se3(*args_r)
        got = InformationMatrixCalculator().calc_information_matrix_se3(*args_p)
        assert got.shape == (6, 6)
        np.testing.assert_allclose(got, want, rtol=1e-6)   # the same fitness
    const = InformationMatrixCalculator(use_const_inf_matrix=True)
    np.testing.assert_array_equal(
        const.calc_information_matrix_se3(*args_p),
        RInf(use_const_inf_matrix=True).calc_information_matrix_se3(*args_r))


# ----------------------------------------------------------------- presets

@pytest.mark.parametrize("name", HDL_PRESETS)
def test_hdl_preset_matches_reference(name):
    """Every leaf of the preset, through config_from_reference_fields."""
    ref = r_get_preset(name)
    port = p_get_preset(name)
    assert config_from_reference_fields(dataclasses.asdict(ref)) == port
    assert port.delta is None and port.backend is port.hdl
    assert port.floor.capacity == 32768 and port.floor.clip_capacity == 8192
    assert port.floor.n_hypotheses == 512
    assert port.hdl.solver.backend == "chain" and port.hdl.solver.chi2_rel_tol == 1e-6
    assert port.hdl.registration.method == "FAST_GICP"


def test_unknown_preset_and_unported_paths_raise():
    """An unknown preset and an unknown neighbour method raise; 'dense'
    neighbours, the nodelet's NDT default and the deskewing prefilter
    construct."""
    with pytest.raises(KeyError, match="hdl_999"):
        p_get_preset("hdl_999")
    cfg = p_get_preset("hdl_400")
    with pytest.raises(ValueError, match="nope"):
        PPipeline(dataclasses.replace(cfg, floor=dataclasses.replace(
            cfg.floor, neighbor_method="nope")), device="cpu")
    dense = PPipeline(dataclasses.replace(cfg, floor=dataclasses.replace(
        cfg.floor, neighbor_method="dense")), device="cpu")
    assert dense.floor.cfg.neighbor_method == "dense"
    be = HdlBackend(HdlBackendConfig(), device="cpu")
    assert be.registration.cfg.head == "ndt" and be.registration.cfg.neighbor_offsets == 7
    pipe = PPipeline(dataclasses.replace(cfg, prefiltering=dataclasses.replace(
        cfg.prefiltering, deskewing=True)), device="cpu")
    assert pipe.prefiltering.cfg.deskewing


def lap_keyframes(be, make):
    """Nine keyframes 2.5 m apart out along x and back: the four on the way
    back revisit the places of the way out (the same scan with other noise),
    so the loop detector's gates pass (accumulated travel >= 8 m, distance
    <= 5 m). Flushed into the graph with nothing solved."""
    rng = np.random.default_rng(3)
    xs = [0.0, 2.5, 5.0, 7.5, 10.0, 7.5, 5.0, 2.5, 0.0]
    for k, x in enumerate(xs):
        odom = np.eye(4)
        odom[0, 3] = x
        pts = city_scan(n=900, seed=100 + int(x * 2)) + rng.normal(
            0, 0.005, (900, 3)).astype(np.float32)
        be.cloud_callback(0.5 * k, odom, make(pts, capacity=1024))
    be.flush_keyframe_queue()


def test_default_backend_ndt_loops_match_reference():
    """HdlBackend(HdlBackendConfig()) on both packages: the nodelet-default
    NDT_OMP registration validates the same loop candidates of a small
    out-and-back graph, with relative poses within 1e-3 m / 1e-4 rad."""
    rcfg = dataclasses.replace(RHdlBackendConfig(), inf=RInf(use_const_inf_matrix=True),
                               keyframe_delta_trans=2.0)
    pcfg = config_from_reference_fields(dataclasses.asdict(rcfg), HdlBackendConfig)
    assert pcfg.registration.method == "NDT_OMP" == rcfg.registration.method
    ref, port = RHdlBackend(rcfg), HdlBackend(pcfg, device="cpu")
    lap_keyframes(ref, lambda p, capacity: R_ops.make_cloud(p, capacity=capacity))
    lap_keyframes(port, lambda p, capacity: make_cloud(p, capacity=capacity))
    n = len(port.new_keyframes)
    assert n == len(ref.new_keyframes) == 9
    loops = []
    for be in (ref, port):
        be.keyframes, be.new_keyframes = be.new_keyframes[:5], be.new_keyframes[5:]
        loops.append(be.loop_detector.detect(be.keyframes, be.new_keyframes, be.poses2d))
    lr, lp = loops
    assert len(lp) == len(lr) >= 1
    for a, b in zip(lp, lr):
        assert (a.key1.stamp, a.key2.stamp) == (b.key1.stamp, b.key2.stamp)
        np.testing.assert_allclose(a.relative_pose[:3, 3], np.asarray(b.relative_pose)[:3, 3],
                                   rtol=0, atol=1e-3)
        dR = a.relative_pose[:3, :3].T @ np.asarray(b.relative_pose)[:3, :3]
        assert np.linalg.norm(dR - dR.T) / (2 * np.sqrt(2)) < 1e-4


@pytest.mark.parametrize("name", ["Pipeline", "HdlBackend", "FloorDetectionStage",
                                  "SE3GraphBuilder", "load_g2o_se3"])
def test_hdl_entry_points_default_to_the_card(monkeypatch, name, tmp_path):
    from delta_graph_slam_tpu_torch.graph import SE3GraphBuilder, load_g2o_se3

    cfg = p_get_preset("hdl_400")
    (tmp_path / "g.g2o").write_text("")
    make = {
        "Pipeline": lambda: PPipeline(cfg),
        "HdlBackend": lambda: HdlBackend(cfg.hdl),
        "FloorDetectionStage": lambda: FloorDetectionStage(cfg.floor),
        "SE3GraphBuilder": lambda: SE3GraphBuilder(),
        "load_g2o_se3": lambda: load_g2o_se3(tmp_path / "g.g2o"),
    }
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        make[name]()


# ------------------------------------------------------ backend bookkeeping

def small_hdl_cfg(get_preset, name="hdl_400"):
    """tests/test_pipeline_e2e.py:131-147's sizes."""
    cfg = get_preset(name)
    pre = dataclasses.replace(cfg.prefiltering, raw_capacity=32768, out_capacity=8192,
                              chunk=1024)
    reg = dataclasses.replace(cfg.odometry.registration, chunk=1024,
                              maximum_iterations=30)
    odo = dataclasses.replace(cfg.odometry, registration=reg, keyframe_delta_trans=1.0)
    floor = dataclasses.replace(cfg.floor, sensor_height=1.8, floor_pts_thresh=100,
                                capacity=8192, chunk=1024)
    hdl = dataclasses.replace(cfg.hdl, registration=reg, keyframe_delta_trans=1.0)
    return dataclasses.replace(cfg, prefiltering=pre, odometry=odo, floor=floor, hdl=hdl)


def feed_backend(be, make, use_gps=True):
    """Five keyframes 2.5 m apart with floor, GPS and IMU messages, through
    the callbacks and the four flushes (no solve)."""
    rng = np.random.default_rng(0)
    for k in range(5):
        stamp = 0.5 * k
        odom = np.eye(4)
        odom[0, 3] = 2.5 * k
        pts = city_scan(n=600, seed=10 + k) + rng.normal(0, 0.01, (600, 3)).astype(np.float32)
        be.floor_coeffs_callback(stamp, [0.0, 0.01 * k, 1.0, 1.8])
        be.floor_coeffs_callback(stamp + 0.3, [0.0, 0.0, 1.0, 1.7])   # matches none
        be.floor_coeffs_callback(stamp, None)
        if use_gps:
            be.gps_callback(stamp + 0.05, 48.0 + 2e-5 * k, 11.0, 500.0)
        be.imu_callback(stamp, [0.999, 0.0, 0.02 * k, 0.0], [0.1, 0.0, 9.8])
        be.cloud_callback(stamp, odom, make(pts, capacity=1024), gt_pose=[2.5 * k, 0, 0])
    flushed = [be.flush_keyframe_queue(), be.flush_floor_queue()]
    be.keyframes.extend(be.new_keyframes)
    be.new_keyframes = []
    flushed += [be.flush_gps_queue(), be.flush_imu_queue()]
    return flushed


@pytest.mark.parametrize("stddev_z", [5.0, 0.0], ids=["gps_xyz", "gps_xy"])
def test_hdl_backend_flushes_match_reference(stddev_z):
    """The same messages through both backends: the same edge list (types,
    endpoints, kernels), measurements and informations, the reference's
    quirks included (GPS and IMU informations over the stddev, the floor's
    over its square, unmatched floor coefficients dropped)."""
    rcfg = dataclasses.replace(
        r_get_preset("hdl_imu").hdl, enable_gps=True, gps_edge_stddev_z=stddev_z,
        floor_edge_robust_kernel="Huber", imu_edge_robust_kernel="Cauchy",
        inf=RInf(use_const_inf_matrix=True))
    pcfg = config_from_reference_fields(dataclasses.asdict(rcfg), HdlBackendConfig)
    ref, port = RHdlBackend(rcfg), HdlBackend(pcfg, device="cpu")
    flushed_r = feed_backend(ref, lambda p, capacity: R_ops.make_cloud(p, capacity=capacity))
    flushed_p = feed_backend(port, lambda p, capacity: make_cloud(p, capacity=capacity))
    assert flushed_p == flushed_r == [True, True, True, True]
    assert port.floor_queue == [] and port.floor_plane_node == ref.floor_plane_node == 0
    assert port.anchor_node == ref.anchor_node
    assert len(port.graph.edges) == len(ref.graph.edges)
    types = {}
    for ep, er in zip(port.graph.edges, ref.graph.edges):
        assert {k: v for k, v in ep.items() if k not in ("meas", "info")} == {
            k: v for k, v in er.items() if k not in ("meas", "info")}
        np.testing.assert_allclose(ep["meas"], er["meas"], rtol=0, atol=1e-12)
        np.testing.assert_allclose(ep["info"], er["info"], rtol=0, atol=1e-12)
        types[ep["type"]] = types.get(ep["type"], 0) + 1
    assert types == {"se3": 5, "se3plane": 5, "quat": 5, "vec": 5,
                     ("xyz" if stddev_z > 0 else "xy"): 5}
    info = {e["type"]: e["info"] for e in port.graph.edges}
    np.testing.assert_allclose(info["se3plane"], np.eye(3) / rcfg.floor_edge_stddev ** 2)
    np.testing.assert_allclose(info["quat"], np.eye(3) / rcfg.imu_orientation_stddev)
    np.testing.assert_allclose(np.stack(port.graph.poses), np.stack(ref.graph.poses),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(port.poses2d, ref.poses2d, rtol=0, atol=1e-12)


def test_hdl_backend_step_solves_and_exports(tmp_path):
    """optimization_step on the fed graph: finite state, the chain + hub
    backend reports nothing dropped, a second step with nothing new returns
    {}, and dump_graph / save_map write what load_g2o_se3 / load_pcd read."""
    from delta_graph_slam_tpu_torch.graph import load_g2o_se3
    from delta_graph_slam_tpu_torch.io.pcd import load_pcd

    cfg = dataclasses.replace(p_get_preset("hdl_imu").hdl,
                              inf=InformationMatrixCalculator(use_const_inf_matrix=True),
                              solver_v_capacity=16, solver_e_capacity=16,
                              solver_prior_capacity=16, solver_offrank_capacity=4)
    be = HdlBackend(cfg, device="cpu")
    rng = np.random.default_rng(0)
    for k in range(6):
        odom = np.eye(4)
        odom[:3, 3] = [2.5 * k, 0.05 * k, 0.02 * k]
        be.floor_coeffs_callback(0.5 * k, [0.0, 0.0, 1.0, 1.8])
        be.imu_callback(0.5 * k, [1.0, 0.0, 0.0, 0.0], [0.0, 0.0, 9.81])
        pts = city_scan(n=600, seed=k) + rng.normal(0, 0.01, (600, 3)).astype(np.float32)
        be.cloud_callback(0.5 * k, odom, make_cloud(pts, capacity=1024),
                          gt_pose=[2.5 * k, 0.0, 0.0])
    s1 = be.optimization_step()       # keyframes and floor; IMU needs keyframes
    s2 = be.optimization_step()       # the IMU edges of those keyframes
    assert s1["lm_iters"] == -1 or s1["lm_iters"] >= 1
    assert s2["lm_iters"] >= 1 and np.isfinite(s2["chi2"]) and s2["loops"] == 0
    assert be.optimization_step() == {}
    assert len(be.keyframes) == 6 and len(be.snapshots) == 6
    assert np.isfinite(np.stack(be.graph.poses)).all()
    # level poses, a level floor: the plane stays the z = 0 floor 1.8 below
    np.testing.assert_allclose(be.graph.planes[0][:3], [0, 0, 1], atol=1e-2)
    m = be.compute_ate_rpe()
    assert m["ATE_mean"] < 0.2
    assert be.dump_graph(tmp_path) and be.save_map(tmp_path, resolution=0.5)
    back = load_g2o_se3(tmp_path / "graph.g2o", device="cpu")
    assert len(back.poses) == 7 and len(back.planes) == 1
    assert sum(e["type"] == "se3plane" for e in back.edges) == 6
    assert len(load_pcd(tmp_path / "map.pcd")) > 100


# -------------------------------------------------- (k) the slice as a whole

@pytest.fixture(scope="module")
def city():
    return synthetic_city_sequence(n_frames=20, speed=3.0)


def drive(pipe, frames, imu=False):
    """GPS, IMU and scan of every frame, the ground truth re-anchored at the
    first frame (the map frame starts at the identity), then finish().
    Returns (edge counts by type, the last cycle's stats)."""
    g0 = se2_inverse_np(frames[0].gt_pose)
    for fr in frames:
        pipe.on_gps(fr.stamp, *fr.gps)
        if imu:      # level flight: identity orientation, gravity-only force
            pipe.on_imu(fr.stamp, [1.0, 0.0, 0.0, 0.0],
                        linear_acceleration=[0.0, 0.0, 9.81])
        pipe.on_points(fr.stamp, fr.points, gt_pose=se2_compose_np(g0, fr.gt_pose))
    stats = pipe.finish()
    types = {}
    for e in pipe.backend.graph.edges:
        types[e["type"]] = types.get(e["type"], 0) + 1
    return types, stats


def test_hdl_400_drive(city):
    """tests/test_pipeline_e2e.py:129-161 through the port on the CPU."""
    _, frames = city
    pipe = PPipeline(small_hdl_cfg(p_get_preset), device="cpu")
    types, stats = drive(pipe, frames[:20])
    be = pipe.backend
    assert isinstance(be, HdlBackend) and len(be.keyframes) >= 3
    assert types.get("se3", 0) >= 3 and types.get("se3plane", 0) >= 1
    assert types["se3"] == len(be.keyframes)     # odometry edges + the anchor edge
    assert be.floor_plane_node is not None
    assert "xy" not in types and "xyz" not in types      # hdl_400 leaves GPS off
    assert stats["lm_iters"] >= 1 and np.isfinite(stats["chi2"])
    assert np.isfinite(be.poses2d).all()
    t = pipe.timing_summary()
    for stage in ("prefiltering", "odometry", "floor_detection", "optimization_step",
                  "backend.optimize", "backend.loop_detection"):
        assert t[stage]["count"] > 0, stage
    m = pipe.evaluate()
    assert m["ATE_mean"] < 1.0


def test_hdl_imu_drive(city):
    """tests/test_pipeline_e2e.py:163-204 through the port on the CPU."""
    _, frames = city
    pipe = PPipeline(small_hdl_cfg(p_get_preset, "hdl_imu"), device="cpu")
    types, _ = drive(pipe, frames[:16], imu=True)
    be = pipe.backend
    assert len(be.keyframes) >= 3
    assert types.get("quat", 0) >= 3 and types.get("vec", 0) >= 3
    assert np.isfinite(be.poses2d).all()
    assert np.isfinite(np.stack(be.graph.poses)).all()


def test_on_imu_reaches_the_delta_backend():
    """on_imu with the delta backend: the first message sets the initial
    orientation yaw, as the JAX backend's imu_callback."""
    from delta_graph_slam_tpu_torch.buildings import StaticProvider

    cfg = p_get_preset("delta")
    cfg = dataclasses.replace(cfg, delta=dataclasses.replace(
        cfg.delta, use_imu_for_initial_orientation=True))
    pipe = PPipeline(cfg, building_provider=StaticProvider("<osm></osm>"), device="cpu")
    yaw = 0.4
    pipe.on_imu(0.0, [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])
    pipe.on_imu(0.1, [1.0, 0.0, 0.0, 0.0])       # later messages change nothing
    np.testing.assert_allclose(pipe.backend.initial_orientation_yaw, yaw, atol=1e-12)
    np.testing.assert_allclose(pipe.backend.trans_odom2map, [0.0, 0.0, yaw], atol=1e-12)


@pytest.mark.slow
def test_hdl_400_drive_matches_reference(city):
    """The 20-frame drive through both pipelines with the JAX floor stream
    replayed: the same keyframes and edge counts, keyframe poses within 5 cm
    and 5 mrad (the front ends agree to the registration's epsilon)."""
    _, frames = city
    ref = RPipeline(small_hdl_cfg(r_get_preset))
    port = PPipeline(small_hdl_cfg(p_get_preset), device="cpu")
    port.floor.sampler = JaxFloorSampler()
    for pipe in (ref, port):
        drive(pipe, frames[:20])
    assert len(port.backend.keyframes) == len(ref.backend.keyframes)
    assert len(port.backend.graph.edges) == len(ref.backend.graph.edges)
    np.testing.assert_allclose(port.backend.poses2d, ref.backend.poses2d, atol=5e-2)
