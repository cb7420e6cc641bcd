"""The port's delta backend (GPS, loop closure, the two-level solve) against
the JAX package's, on the same numpy inputs.

Methods are named where the JAX package would pick by platform:
``neighbor_method='voxel'`` for the prefilter and ``cov_method='knn'``
for FAST_GICP. Clouds cross between the packages through interop.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from delta_graph_slam_tpu import ops as r_ops
from delta_graph_slam_tpu.buildings import StaticProvider as RStatic
from delta_graph_slam_tpu.buildings import parse_osm_xml as r_parse_osm_xml
from delta_graph_slam_tpu.geom import projection as r_projection
from delta_graph_slam_tpu.geom.host import (
    se2_compose_np, se2_inverse_np, transform_2d_to_3d_np,
)
from delta_graph_slam_tpu.graph import SE2GraphBuilder as RBuilder
from delta_graph_slam_tpu.graph import load_g2o as r_load_g2o
from delta_graph_slam_tpu.io.kitti import synthetic_city_sequence
from delta_graph_slam_tpu.io.nmea import NmeaSentenceParser as RNmea
from delta_graph_slam_tpu.models.delta_backend import DeltaBackend as RBackend
from delta_graph_slam_tpu.models.prefiltering import PrefilteringStage as RPrefilter
from delta_graph_slam_tpu.pipeline.keyframe import KeyFrame as RKeyFrame
from delta_graph_slam_tpu.pipeline.loop_detector import LoopDetector as RLoopDetector
from delta_graph_slam_tpu.register import RegistrationConfig as RRegConfig
from delta_graph_slam_tpu.register import make_registration as r_make_registration
from delta_graph_slam_tpu.utils.metrics import ate_rpe_se2 as r_ate_rpe_se2
from delta_graph_slam_tpu_torch.buildings import Building, BuildingManager, StaticProvider
from delta_graph_slam_tpu_torch.buildings import parse_osm_xml
from delta_graph_slam_tpu_torch.config import get_preset as p_get_preset
from delta_graph_slam_tpu_torch.geom import projection
from delta_graph_slam_tpu_torch.graph import SE2GraphBuilder
from delta_graph_slam_tpu_torch.interop import (
    cloud_from_numpy, cloud_to_numpy, config_from_reference_fields,
)
from delta_graph_slam_tpu_torch.io import kitti as p_kitti
from delta_graph_slam_tpu_torch.io.lidar_sim import LidarModel, raycast_scan
from delta_graph_slam_tpu_torch.io.nmea import NmeaSentenceParser
from delta_graph_slam_tpu_torch.models.delta_backend import DeltaBackend, DeltaBackendConfig
from delta_graph_slam_tpu_torch.ops.cloud import make_cloud
from delta_graph_slam_tpu_torch.pipeline.keyframe import KeyFrame
from delta_graph_slam_tpu_torch.pipeline.loop_detector import LoopDetector
from delta_graph_slam_tpu_torch.pipeline.runner import Pipeline
from delta_graph_slam_tpu_torch.register.config import RegistrationConfig
from delta_graph_slam_tpu_torch.register.engine import make_registration
from delta_graph_slam_tpu_torch.utils.metrics import ate_rpe_se2

torch.set_num_threads(2)
EMPTY = "<osm></osm>"
GPS0 = (49.01, 8.40)


def _small_delta_reference():
    """tests/test_pipeline_e2e.py:36-57 (small_delta_cfg), methods named."""
    from delta_graph_slam_tpu.config import get_preset

    cfg = get_preset("delta")
    pre = dataclasses.replace(cfg.prefiltering, raw_capacity=16384,
                              out_capacity=4096, chunk=1024,
                              neighbor_method="voxel")
    reg = dataclasses.replace(cfg.odometry.registration, chunk=1024,
                              maximum_iterations=30, cov_method="knn")
    delta = dataclasses.replace(
        cfg.delta, registration=reg, keyframe_delta_trans=1.0,
        keyframe_delta_angle=1.0, graph_update_interval=2.0,
        compute_ate_rpe=True, solver_v_capacity=64, solver_e_capacity=256,
    )
    return pre, delta


def _empty_cloud():
    return make_cloud(np.zeros((4, 3), np.float32), np.zeros(4, bool))


# ------------------------------------------------------- GPS and host I/O

def test_keyframes_wait_for_the_first_gps_fix():
    """The reference's cloud_callback returns until the first GPS fix has
    made the building manager (delta_backend.py:354-356)."""
    be = DeltaBackend(DeltaBackendConfig(keyframe_delta_trans=0.5),
                      StaticProvider(EMPTY))
    c = _empty_cloud()
    odom = np.eye(4)
    for k in range(3):
        odom[0, 3] = float(k)
        be.cloud_callback(0.1 * k, odom.copy(), c, c)
    assert be.buildings_manager is None and not be.keyframe_queue
    be.gps_callback(0.3, *GPS0)
    assert be.buildings_manager is not None
    for k in range(3, 6):
        odom[0, 3] = float(k)
        be.cloud_callback(0.1 * k, odom.copy(), c, c)
    assert [kf.stamp for kf in be.keyframe_queue] == pytest.approx([0.3, 0.4, 0.5])


def test_gps_without_a_provider_raises():
    be = DeltaBackend(DeltaBackendConfig())
    with pytest.raises(ValueError, match="provider"):
        be.gps_callback(0.0, *GPS0)


def test_flush_gps_queue_priors_match_reference():
    """GPS fixes within 0.1 s of a keyframe become level-0 xy priors with
    information I / stddev (the reference's quirk, :481-487)."""
    over = dict(enable_gps_priors=True, gps_edge_stddev_xy=20.0,
                gps_edge_robust_kernel="Huber", gps_edge_robust_kernel_size=2.0)
    _, rdelta = _small_delta_reference()
    rdelta = dataclasses.replace(rdelta, compute_ate_rpe=False, **over)
    ref = RBackend(rdelta, RStatic(EMPTY))
    port = DeltaBackend(config_from_reference_fields(dataclasses.asdict(rdelta),
                                                     DeltaBackendConfig),
                        StaticProvider(EMPTY))
    fixes = [(0.3 * k, GPS0[0] + 1e-5 * k, GPS0[1] + 2e-5 * k) for k in range(6)]
    for be in (ref, port):
        for f in fixes:
            be.gps_callback(*f)
    # 0.45 has no fix within 0.1 s; 2.0 lies after the last fix
    stamps = [0.05, 0.45, 0.62, 1.25, 2.0]
    for be, KF in ((ref, RKeyFrame), (port, KeyFrame)):
        for k, s in enumerate(stamps):
            be.keyframes.append(KF(stamp=s, odom=np.eye(4), odom2d=np.zeros(3),
                                   accum_distance=float(k), cloud=None,
                                   flat_cloud=None,
                                   node_id=be.graph.add_vertex(np.zeros(3))))
    assert ref.flush_gps_queue() and port.flush_gps_queue()
    r_pri = [e for e in ref.graph.edges if e["type"] == "xy"]
    p_pri = [e for e in port.graph.edges if e["type"] == "xy"]
    assert [e["i"] for e in p_pri] == [e["i"] for e in r_pri] == [0, 2, 3]
    for ep, er in zip(p_pri, r_pri):
        assert (ep["level"], ep["kernel"], ep["delta"]) == (er["level"], er["kernel"], er["delta"])
        np.testing.assert_array_equal(ep["meas"], er["meas"])     # float64 host math
        np.testing.assert_array_equal(ep["info"], np.eye(2) / 20.0)
    assert [g[0] for g in port.gps_queue] == [g[0] for g in ref.gps_queue]
    np.testing.assert_array_equal(port.keyframes[2].gps_coord, ref.keyframes[2].gps_coord)


def test_projection_nmea_and_osm_parse_match_reference():
    lat, lon = np.array([49.0, 49.001, 48.5]), np.array([8.4, 8.41, 9.0])
    sc = projection.mercator_scale(49.0)
    assert sc == r_projection.mercator_scale(49.0)
    xyz = projection.mercator_from_gps(lat, lon, 1.0, scale=sc)
    np.testing.assert_array_equal(xyz, r_projection.mercator_from_gps(lat, lon, 1.0, scale=sc))
    np.testing.assert_array_equal(projection.gps_from_mercator(xyz, scale=sc),
                                  r_projection.gps_from_mercator(xyz, scale=sc))
    for s in ("$GPRMC,123519,A,4807.038,N,01131.000,E,022.4,084.4,230394,003.1,W*6A",
              "$GPRMC,123519,V,4807.038,N,01131.000,E,022.4,084.4,230394,003.1,W*7D",
              "$GPRMC,123519,A,4807.038,S,01131.000,W,,,230394,,*6A"):
        assert (dataclasses.asdict(NmeaSentenceParser().parse(s))
                == dataclasses.asdict(RNmea().parse(s)))
    world = p_kitti.make_city_world(seed=0)
    assert parse_osm_xml(world.osm_xml()) == r_parse_osm_xml(world.osm_xml())


def test_nmea_callback_sets_the_origin():
    be = DeltaBackend(DeltaBackendConfig(), StaticProvider(EMPTY))
    be.nmea_callback(0.0, "$GPRMC,123519,A,4807.038,N,01131.000,E,022.4,084.4,"
                          "230394,003.1,W*6A")
    assert be.scale == pytest.approx(np.cos(np.deg2rad(48 + 7.038 / 60)))
    assert be.gps_queue and be.buildings_manager is not None


def test_buildings_in_range_become_buildings():
    """OSM ways in range become Building entities with their outline on
    the manager's device (the parity with the reference is
    tests/test_torch_buildings.py); a world without buildings yields none."""
    world = p_kitti.make_city_world(seed=0)
    mgr = BuildingManager(StaticProvider(world.osm_xml()),
                          projection.mercator_from_gps(*world.origin_gps, 0.0,
                                                       scale=1.0), 1.0,
                          synchronous=True)
    got = mgr.get_buildings(*world.origin_gps)
    assert got and all(isinstance(b, Building) and b.node_id is None for b in got)
    assert all(b.lines.mask.any() and b.cloud.mask.any() for b in got)
    empty = BuildingManager(StaticProvider(EMPTY), np.zeros(3), 1.0)
    assert empty.get_buildings(*GPS0) == []


# ----------------------------------------------------------- graph, runner

def test_edge_ids_stay_unique_after_remove_edge():
    """Edge ids are monotonic (graph/se2_graph.py:145-156): removing an edge
    never lets a later edge reuse a live id."""
    ref, port = RBuilder(), SE2GraphBuilder()
    for b in (ref, port):
        for k in range(4):
            b.add_vertex([float(k), 0.0, 0.0])
        ids = [b.add_se2_edge(k, k + 1, [1.0, 0.0, 0.0], np.eye(3)) for k in range(3)]
        b.remove_edge(ids[1])
        ids.append(b.add_se2_edge(0, 3, [3.0, 0.0, 0.0], np.eye(3)))
        ids.append(b.add_prior_xy(2, [2.0, 0.0], np.eye(2)))
    assert [e["id"] for e in port.edges] == [e["id"] for e in ref.edges] == [0, 2, 3, 4]
    assert len({e["id"] for e in port.edges}) == len(port.edges)


def test_finish_runs_a_final_step():
    """Pipeline.finish() runs at least one optimization step and up to ten,
    stopping on an empty result with an empty queue (runner.py:299-306)."""
    pre, delta = _small_delta_reference()
    cfg = p_get_preset("delta")
    pipe = Pipeline(cfg, building_provider=StaticProvider(EMPTY))
    calls = []
    results = [{"loops": 0}, {"loops": 1}, {}]

    def step():
        calls.append(len(calls))
        return results[len(calls) - 1] if len(calls) <= len(results) else {}

    pipe.backend.optimization_step = step
    assert pipe.finish() == {"loops": 1} and len(calls) == 3
    calls.clear()
    results[:] = []
    assert pipe.finish() == {} and len(calls) == 1      # nothing queued: one step
    calls.clear()
    pipe.backend.keyframe_queue.append(object())      # never drains
    pipe.finish()
    assert len(calls) == 10


def test_ate_rpe_matches_reference():
    rng = np.random.default_rng(1)
    gts = np.cumsum(rng.normal(size=(9, 3)) * [1.0, 1.0, 0.1], 0)
    ests = gts + rng.normal(size=gts.shape) * 0.05
    assert ate_rpe_se2(list(ests), list(gts)) == pytest.approx(
        r_ate_rpe_se2(list(ests), list(gts)), rel=1e-12)
    assert ate_rpe_se2(list(ests[:1]), list(gts[:1])) is None


# ------------------------------------------------------------ loop closure

def _kf_pair(KF, cloud_a=None, cloud_b=None):
    old = KF(stamp=0.0, odom=np.eye(4), odom2d=np.zeros(3), accum_distance=0.0,
             cloud=cloud_a, flat_cloud=None, node_id=0)
    new = KF(stamp=1.0, odom=np.eye(4), odom2d=np.zeros(3), accum_distance=20.0,
             cloud=cloud_b, flat_cloud=None, node_id=1)
    return old, new


GATE_CASES = {
    # (last_edge_accum, old accum, new accum, poses): tests/test_loop_detector.py:54-98
    "accepts_near_old_keyframe": (0.0, 0.0, 20.0, [[0, 0, 0], [1.0, 0.5, 0.1]]),
    "min_edge_interval": (18.0, 0.0, 20.0, [[0, 0, 0], [1.0, 0, 0]]),
    "accum_distance": (0.0, 15.0, 20.0, [[0, 0, 0], [1.0, 0, 0]]),
    "distance": (0.0, 0.0, 20.0, [[0, 0, 0], [20.0, 0, 0]]),
    "estimated_not_odom": (0.0, 0.0, 20.0, [[0, 0, 0], [2.0, 0, 0]]),
}


@pytest.mark.parametrize("case", list(GATE_CASES))
def test_loop_candidate_gates_match_reference(case):
    last, acc_old, acc_new, poses = GATE_CASES[case]
    poses = np.asarray(poses, np.float64)
    got = []
    for Det, KF in ((RLoopDetector, RKeyFrame), (LoopDetector, KeyFrame)):
        det = Det(None, distance_thresh=5.0, accum_distance_thresh=8.0,
                  min_edge_interval=5.0)
        det.last_edge_accum_distance = last
        old, new = _kf_pair(KF)
        old.accum_distance, new.accum_distance = acc_old, acc_new
        old.odom2d = np.array([50.0, 50.0, 0.0])     # stale odometry, unused
        got.append([k.node_id for k in det.find_candidates([old], new, poses)])
    assert got[0] == got[1]
    assert got[1] == ([0] if case in ("accepts_near_old_keyframe",
                                      "estimated_not_odom") else [])


def test_loop_matching_matches_reference():
    """One raycast scan pair 0.6 m / 0.05 rad apart, registered through both
    packages' LoopDetector.matching (FAST_GICP, kNN covariances)."""
    world = p_kitti.make_city_world(seed=0)
    model = LidarModel(n_beams=32, azimuth_step_deg=1.0, dropout=0.05)
    pose_a, pose_b = np.array([-40.0, 0.5, 0.0]), np.array([-39.4, 0.7, 0.05])
    rng = np.random.default_rng(0)
    clouds = []
    for k, pose in enumerate((pose_a, pose_b)):
        pts = raycast_scan(world, pose, model=model, seed=k)
        pts = pts[np.linalg.norm(pts, axis=1) < 30.0]
        clouds.append(pts[rng.permutation(len(pts))[:4096]])
    kw = dict(method="FAST_GICP", transformation_epsilon=0.01, maximum_iterations=40,
              max_correspondence_distance=2.0, correspondence_randomness=10,
              chunk=512, cov_method="knn")
    poses = np.stack([pose_a, pose_b])        # graph estimates: the true poses
    out = []
    for Det, KF, reg, mk in (
            (RLoopDetector, RKeyFrame, r_make_registration(RRegConfig(**kw)),
             lambda p: r_ops.make_cloud(p, capacity=4096)),
            (LoopDetector, KeyFrame, make_registration(RegistrationConfig(**kw)),
             lambda p: make_cloud(p, capacity=4096))):
        det = Det(reg, distance_thresh=5.0, accum_distance_thresh=8.0,
                  min_edge_interval=5.0, fitness_score_thresh=0.5)
        old, new = _kf_pair(KF, mk(clouds[0]), mk(clouds[1]))
        loop = det.matching([old], new, poses)
        assert loop is not None and loop.key2 is old
        assert det.last_edge_accum_distance == 20.0
        out.append(loop)
    r, p = out
    # the registration bound of tests/test_torch_pipeline.py: 1e-2 m, 1e-3 rad
    assert np.abs(p.relpose_2d[:2] - r.relpose_2d[:2]).max() < 1e-2
    assert abs(p.relpose_2d[2] - r.relpose_2d[2]) < 1e-3
    # the true pose of the old scan in the new one's frame, within 5 cm
    truth = se2_compose_np(se2_inverse_np(pose_b), pose_a)
    assert np.abs(p.relpose_2d - truth).max() < 0.05, (p.relpose_2d, truth)


# ------------------------------------------------- the backend parity run

@pytest.fixture(scope="module")
def drift_lap():
    """tests/test_pipeline_e2e.py:334-390: a 52-frame out-and-back lap,
    keyframe odometry = ground truth composed with an injected random-walk
    drift, the same prefiltered clouds to both packages; and the world whose
    buildings tests/test_torch_building_drive.py drives them against."""
    world, frames = synthetic_city_sequence(n_frames=52, speed=3.0,
                                            trajectory="lap", turn_frames=20)
    from delta_graph_slam_tpu.geom import se2_compose as r_compose, se2_inverse as r_inverse
    import jax.numpy as jnp

    g0 = r_inverse(jnp.asarray(frames[0].gt_pose))
    gts = [np.asarray(r_compose(g0, jnp.asarray(fr.gt_pose))) for fr in frames]
    pre_cfg, _ = _small_delta_reference()
    pre = RPrefilter(pre_cfg)
    clouds = []
    for fr in frames:
        out = pre.process(fr.points)
        clouds.append((cloud_to_numpy(out.filtered3d), cloud_to_numpy(out.filtered2d)))
    return world, frames, gts, clouds


def _drive(frames, gts, clouds, enable_loops, port):
    _, delta = _small_delta_reference()
    delta = dataclasses.replace(
        delta, distance_thresh=6.0, accum_distance_thresh=6.0,
        min_edge_interval=3.0 if enable_loops else 1e18,
        fitness_score_thresh=1.0, enable_buildings=False)
    if port:
        be = DeltaBackend(config_from_reference_fields(dataclasses.asdict(delta),
                                                       DeltaBackendConfig),
                          StaticProvider(EMPTY))
    else:
        be = RBackend(delta, RStatic(EMPTY))
    rng = np.random.default_rng(3)
    drift = np.zeros(3)
    last = frames[0].stamp
    steps = []
    for fr, gt, (c3, c2) in zip(frames, gts, clouds):
        be.gps_callback(fr.stamp, *fr.gps)
        drift = drift + np.array([rng.normal(0.004, 0.004), rng.normal(0.006, 0.004),
                                  rng.normal(0.0015, 0.001)])
        mk = cloud_from_numpy if port else (lambda p, m: r_ops.make_cloud(p, m))
        be.cloud_callback(fr.stamp, transform_2d_to_3d_np(se2_compose_np(gt, drift)),
                          mk(*c3), mk(*c2), gt_pose=gt)
        if fr.stamp - last >= delta.graph_update_interval:
            steps.append((be.optimization_step(), be.poses.copy()))
            last = fr.stamp
    steps.append((be.optimization_step(), be.poses.copy()))
    return be, steps


def _loop_edges(be):
    nodes = [k.node_id for k in be.keyframes]
    consecutive = {frozenset(p) for p in zip(nodes[1:], nodes[:-1])}
    return [e for e in be.graph.edges
            if e["type"] == "se2" and e["i"] in nodes and e["j"] in nodes
            and frozenset((e["i"], e["j"])) not in consecutive]


def test_backend_parity_on_the_drift_lap(drift_lap, tmp_path):
    _, frames, gts, clouds = drift_lap
    ref, r_steps = _drive(frames, gts, clouds, True, port=False)
    port, p_steps = _drive(frames, gts, clouds, True, port=True)
    assert [k.stamp for k in port.keyframes] == [k.stamp for k in ref.keyframes]
    assert [k.node_id for k in port.keyframes] == [k.node_id for k in ref.keyframes]
    r_loops, p_loops = _loop_edges(ref), _loop_edges(port)
    assert len(p_loops) >= 1
    assert [(e["i"], e["j"]) for e in p_loops] == [(e["i"], e["j"]) for e in r_loops]
    for ep, er in zip(p_loops, r_loops):
        np.testing.assert_allclose(ep["info"], er["info"], rtol=1e-3)
    odo = [(e, f) for e, f in zip(port.graph.edges, ref.graph.edges)]
    for ep, er in odo:
        assert (ep["i"], ep["j"], ep["type"]) == (er["i"], er["j"], er["type"])
        np.testing.assert_allclose(ep["info"], er["info"], rtol=1e-3)
    assert len(p_steps) == len(r_steps)
    for (sp, pp), (sr, pr) in zip(p_steps, r_steps):
        assert sp["loops"] == sr["loops"]
        # the registration bound of tests/test_torch_pipeline.py: 1e-2 m, 1e-3 rad
        assert np.abs(pp[:, :2] - pr[:, :2]).max() < 1e-2
        assert np.abs(pp[:, 2] - pr[:, 2]).max() < 1e-3
    m_p, m_r = port.compute_ate_rpe(), ref.compute_ate_rpe()
    assert abs(m_p["ATE_mean"] - m_r["ATE_mean"]) < 1e-2
    # loop closure pays: the port's run without loops ends worse
    none, _ = _drive(frames, gts, clouds, False, port=True)
    assert not _loop_edges(none)
    assert m_p["ATE_mean"] < none.compute_ate_rpe()["ATE_mean"]
    # the graph file the port dumps is one the JAX package reads
    port.dump_graph(tmp_path)
    back = r_load_g2o(tmp_path / "graph.g2o")
    assert len(back.poses) == len(port.graph.poses)
    assert len(back.edges) == len(port.graph.edges)
