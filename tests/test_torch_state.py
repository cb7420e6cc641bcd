"""Checkpoints, markers and map->odom of the port against the JAX package,
on the CPU.

A state written by either package loads in the other (models/
delta_backend.py save_state / load_state: the same npz keys, object arrays
of the valid points, the graph sidecar of graph/graph_io.py). The building
drive is tests/test_torch_building_drive.py's (its small line matcher, the
world with one overlapping building), driven by the port alone.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from delta_graph_slam_tpu.buildings import StaticProvider as RStatic
from delta_graph_slam_tpu.io.tf_table import TransformTable as RTable
from delta_graph_slam_tpu.models.delta_backend import DeltaBackend as RBackend
from delta_graph_slam_tpu.pipeline.map2odom import Map2OdomPublisher as RPublisher
from delta_graph_slam_tpu.utils import markers as r_markers
from delta_graph_slam_tpu_torch.buildings import StaticProvider
from delta_graph_slam_tpu_torch.geom.host import (
    se2_compose_np, se2_inverse_np, transform_2d_to_3d_np,
)
from delta_graph_slam_tpu_torch.interop import cloud_from_numpy, config_from_reference_fields
from delta_graph_slam_tpu_torch.io.lidar_sim import raycast_city_sequence
from delta_graph_slam_tpu_torch.io.tf_table import TransformTable
from delta_graph_slam_tpu_torch.models.delta_backend import DeltaBackend, DeltaBackendConfig
from delta_graph_slam_tpu_torch.pipeline.map2odom import Map2OdomPublisher
from delta_graph_slam_tpu_torch.pipeline.runner import Pipeline
from delta_graph_slam_tpu_torch.utils import markers
from test_torch_backend import drift_lap  # noqa: F401 (fixture)
from test_torch_building_drive import _delta_config, _overlapping_world
from test_torch_cli import small_building_cfg

torch.set_num_threads(2)
HALF = 30            # frames of the drift lap driven before the checkpoint
CAP = 4096           # the small prefilter's out capacity (both clouds)


def port_backend(world):
    return DeltaBackend(config_from_reference_fields(dataclasses.asdict(_delta_config()),
                                                     DeltaBackendConfig),
                        StaticProvider(world.osm_xml()), device="cpu")


@pytest.fixture(scope="module")
def saved(drift_lap, tmp_path_factory):  # noqa: F811 (the imported fixture)
    """The port's building drive over the first HALF frames of the drift lap,
    optimized, and saved; returns (world, backend, checkpoint path)."""
    world, frames, gts, clouds = drift_lap
    world = _overlapping_world(world, frames)
    be = port_backend(world)
    rng = np.random.default_rng(3)
    drift = np.zeros(3)
    last = frames[0].stamp
    for fr, gt, (c3, c2) in list(zip(frames, gts, clouds))[:HALF]:
        be.gps_callback(fr.stamp, *fr.gps)
        drift = drift + np.array([rng.normal(0.004, 0.004), rng.normal(0.006, 0.004),
                                  rng.normal(0.0015, 0.001)])
        be.cloud_callback(fr.stamp, transform_2d_to_3d_np(se2_compose_np(gt, drift)),
                          cloud_from_numpy(*c3), cloud_from_numpy(*c2), gt_pose=gt)
        if fr.stamp - last >= 2.0:
            be.optimization_step()
            last = fr.stamp
    be.optimization_step()
    path = tmp_path_factory.mktemp("state") / "state.npz"
    be.save_state(path)
    return world, be, path


def _valid(cloud):
    return cloud.points[cloud.mask].cpu().numpy() if isinstance(cloud.points, torch.Tensor) \
        else np.asarray(cloud.points)[np.asarray(cloud.mask)]


def assert_same_state(got, want, tol=1e-12):
    """Poses, keyframes, buildings and the edge tables of two backends of
    either package, within ``tol``."""
    np.testing.assert_allclose(got.poses, want.poses, rtol=0, atol=tol)
    assert len(got.keyframes) == len(want.keyframes) > 5
    for a, b in zip(got.keyframes, want.keyframes):
        assert a.stamp == b.stamp and a.node_id == b.node_id
        assert a.accum_distance == pytest.approx(b.accum_distance, abs=tol)
        for f in ("odom", "odom2d", "estimated_odom", "gps_coord", "gt_pose"):
            x, y = getattr(a, f), getattr(b, f)
            assert (x is None) == (y is None), f
            if x is not None:
                np.testing.assert_allclose(np.asarray(x, float), np.asarray(y, float),
                                           rtol=0, atol=tol, err_msg=f)
        np.testing.assert_array_equal(_valid(a.cloud), _valid(b.cloud))
        np.testing.assert_array_equal(_valid(a.flat_cloud), _valid(b.flat_cloud))
    ba, bb = got.buildings_manager.buildings, want.buildings_manager.buildings
    assert [(b.id, b.node_id) for b in ba] == [(b.id, b.node_id) for b in bb]
    assert len(ba) >= 3
    for a, b in zip(ba, bb):
        np.testing.assert_allclose(a.pose, b.pose, rtol=0, atol=tol)
        np.testing.assert_allclose(a.corners, b.corners, rtol=0, atol=tol)
    for t in ("se2", "xy", "yaw"):
        ea = [e for e in got.graph.edges if e["type"] == t]
        eb = [e for e in want.graph.edges if e["type"] == t]
        assert [(e["i"], e["j"], e["level"], e["kernel"]) for e in ea] == [
            (e["i"], e["j"], e["level"], e["kernel"]) for e in eb]
        for x, y in zip(ea, eb):
            np.testing.assert_allclose(x["meas"], y["meas"], rtol=0, atol=tol)
            np.testing.assert_allclose(x["info"], y["info"], rtol=0, atol=tol)
    np.testing.assert_allclose(got.trans_odom2map, want.trans_odom2map, rtol=0, atol=tol)
    assert got.anchor_node == want.anchor_node


@pytest.fixture(scope="module")
def round_trip(saved, tmp_path_factory):
    """port save -> JAX load -> JAX save -> port load."""
    world, be, path = saved
    ref = RBackend(_delta_config(), RStatic(world.osm_xml()))
    ref.load_state(str(path), cloud_capacity=CAP, flat_capacity=CAP)
    path2 = tmp_path_factory.mktemp("state_ref") / "state.npz"
    ref.save_state(str(path2))
    port = port_backend(world)
    port.load_state(path2, cloud_capacity=CAP, flat_capacity=CAP)
    return be, ref, port


def test_state_round_trips_through_the_reference(round_trip):
    be, ref, port = round_trip
    assert_same_state(ref, be)       # the JAX package reads the port's file
    assert_same_state(port, be)      # and the port reads the JAX package's
    # the loaded graph solves: the level-0 and level-1 edges are all there
    assert {(e["type"], e["level"]) for e in port.graph.edges} >= {
        ("se2", 0), ("se2", 1), ("xy", 0), ("yaw", 0), ("xy", 1)}
    assert port.buildings_manager.buildings[0].cloud.mask.any()


def test_create_marker_array_matches_reference(round_trip):
    _, ref, port = round_trip
    got, want = port.create_marker_array(), ref.create_marker_array()
    assert sorted(got) == sorted(want)
    assert got["edges"] == want["edges"] and len(got["edges"]) > 10
    assert got["loop_close_radius"] == want["loop_close_radius"]
    for k in ("keyframe_nodes", "building_nodes", "node_xy", "gps", "gt_pose"):
        np.testing.assert_allclose(np.asarray(got[k], float), np.asarray(want[k], float),
                                   rtol=0, atol=1e-12, err_msg=k)


def test_save_viz_bytes_match_reference(round_trip, tmp_path):
    """markers.json and markers.svg byte for byte, for the same marker dict
    (with and without a map cloud); markers.png needs matplotlib, which
    neither package finds here, so both return False."""
    _, ref, _ = round_trip
    mk = ref.create_marker_array()
    mc = np.random.default_rng(0).uniform(-5, 60, (3000, 3))
    for cloud in (None, mc):
        got = markers.save_viz(mk, tmp_path / "p", map_cloud=cloud)
        want = r_markers.save_viz(mk, tmp_path / "r", map_cloud=cloud)
        assert got == want
        for name in ("markers.json", "markers.svg"):
            assert (tmp_path / "p" / name).read_bytes() == (tmp_path / "r" / name).read_bytes()
    svg = (tmp_path / "p" / "markers.svg").read_text()
    assert svg.count("<line") == len(mk["edges"])
    assert len(json.loads((tmp_path / "p" / "markers.json").read_text())["edges"]) == len(
        mk["edges"])


def test_map2odom_publish_once_matches_reference(round_trip):
    _, ref, port = round_trip
    tables = (TransformTable(), RTable())
    pubs = (Map2OdomPublisher(tables[0], port), RPublisher(tables[1], ref))
    for t in tables:      # identity until the first publish
        np.testing.assert_array_equal(t.lookup("map", "odom"), np.eye(4))
    for p in pubs:
        p.publish_once()
    got, want = (t.lookup("map", "odom") for t in tables)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, transform_2d_to_3d_np(port.trans_odom2map))
    np.testing.assert_allclose(tables[0].lookup("odom", "map"), np.linalg.inv(got))
    # the 10 Hz thread re-publishes a changed estimate, and stops
    port.trans_odom2map = port.trans_odom2map + np.array([1.0, 0.0, 0.1])
    pubs[0].rate_hz = 100.0
    pubs[0].start()
    try:
        for _ in range(200):
            if not np.array_equal(tables[0].lookup("map", "odom"), got):
                break
            pubs[0]._stop.wait(0.01)
    finally:
        pubs[0].stop()
    assert not pubs[0]._thread.is_alive()
    np.testing.assert_allclose(tables[0].lookup("map", "odom"),
                               transform_2d_to_3d_np(port.trans_odom2map))


def test_pipeline_resume_continues(tmp_path):
    """tests/test_pipeline_e2e.py:395-450 on the port: a pipeline saved half
    way through a raycast city drive, loaded into a fresh pipeline (backend
    and odometry stage), continues with the rest of the scans."""
    world, frames = raycast_city_sequence(n_frames=28, speed=3.0)
    g0 = se2_inverse_np(frames[0].gt_pose)
    gts = [se2_compose_np(g0, fr.gt_pose) for fr in frames]
    cfg = small_building_cfg()
    half = len(frames) // 2
    pipe = Pipeline(cfg, building_provider=StaticProvider(world.osm_xml()), device="cpu")
    for fr, gt in zip(frames[:half], gts[:half]):
        pipe.on_gps(fr.stamp, *fr.gps)
        pipe.on_points(fr.stamp, fr.points, gt_pose=gt)
    pipe.finish()
    path = tmp_path / "state.npz"
    pipe.save_state(path)
    assert (tmp_path / "state.npz.graph.npz").exists()
    assert (tmp_path / "state.npz.odom.npz").exists()

    resumed = Pipeline(cfg, building_provider=StaticProvider(world.osm_xml()), device="cpu")
    resumed.load_state(path, cloud_capacity=CAP, flat_capacity=CAP)
    b1, b2 = pipe.backend, resumed.backend
    assert len(b2.keyframes) == len(b1.keyframes)
    # tests/test_pipeline_e2e.py:417: the poses at the save point, 1e-6 m
    np.testing.assert_allclose(b2.poses, b1.poses, atol=1e-6)
    assert len(b2.buildings_manager.buildings) == len(b1.buildings_manager.buildings)
    np.testing.assert_array_equal(resumed.odometry.keyframe_pose, pipe.odometry.keyframe_pose)
    for fr, gt in zip(frames[half:], gts[half:]):
        resumed.on_gps(fr.stamp, *fr.gps)
        resumed.on_points(fr.stamp, fr.points, gt_pose=gt)
    resumed.finish()
    assert len(b2.keyframes) > len(b1.keyframes)
    m = resumed.evaluate()
    assert m is not None and m["ATE_mean"] < 2.0, m     # the reference test's bound
