"""Whole-slice parity of the port with the JAX package, and packaging.

The slice is prefilter -> FAST_GICP odometry -> keyframe admission ->
odometry edges with fitness-based information matrices, on 12 raycast
frames at the small_delta_cfg scale (raw 16384, out 4096, chunk 1024, at
most 30 GN iterations, keyframe gates 1.0 m / 1.0 rad).
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from delta_graph_slam_tpu.buildings import StaticProvider
from delta_graph_slam_tpu_torch.buildings import StaticProvider as PStaticProvider
from delta_graph_slam_tpu.config import get_preset as r_get_preset
from delta_graph_slam_tpu.io import kitti as r_kitti
from delta_graph_slam_tpu.io import lidar_sim as r_lidar_sim
from delta_graph_slam_tpu.pipeline.runner import Pipeline as RPipeline
from delta_graph_slam_tpu_torch.config import get_preset as p_get_preset
from delta_graph_slam_tpu_torch.interop import (
    cloud_from_numpy, cloud_to_numpy, config_from_reference_fields,
)
from delta_graph_slam_tpu_torch.io import kitti as p_kitti
from delta_graph_slam_tpu_torch.io import lidar_sim as p_lidar_sim
from delta_graph_slam_tpu_torch.pipeline.runner import Pipeline as PPipeline

torch.set_num_threads(2)

N_FRAMES = 12


def _small(get_preset):
    """small_delta_cfg (tests/test_pipeline_e2e.py:36-57) for the slice's
    stages, with the 'auto' methods named: voxel neighbours, kNN covs."""
    cfg = get_preset("delta")
    pre = dataclasses.replace(cfg.prefiltering, raw_capacity=16384,
                              out_capacity=4096, chunk=1024,
                              neighbor_method="voxel")
    reg = dataclasses.replace(cfg.odometry.registration, chunk=1024,
                              maximum_iterations=30, cov_method="knn")
    odo = dataclasses.replace(cfg.odometry, registration=reg)
    delta = dataclasses.replace(cfg.delta, keyframe_delta_trans=1.0,
                                keyframe_delta_angle=1.0,
                                graph_update_interval=2.0)
    if hasattr(cfg.delta, "registration"):      # the reference's backend
        delta = dataclasses.replace(delta, registration=reg)
    return dataclasses.replace(cfg, prefiltering=pre, odometry=odo, delta=delta)


def _rot_angle(Ta, Tb):
    dR = Ta[:3, :3].T @ Tb[:3, :3]
    return np.linalg.norm(dR - dR.T) / (2 * np.sqrt(2))


@pytest.fixture(scope="module")
def runs():
    world, frames = p_lidar_sim.raycast_city_sequence(n_frames=N_FRAMES,
                                                      speed=3.0)
    ref = RPipeline(_small(r_get_preset),
                    building_provider=StaticProvider("<osm>\n</osm>"),
                    base_T=np.eye(4))
    # the reference's per-frame GN iteration count (not in its OdometryFrame)
    ref_iters = []
    step = ref.odometry._status_step

    def counting_step(*a):
        out = step(*a)
        ref_iters.append(int(np.asarray(out)[17]))
        return out

    ref.odometry._status_step = counting_step
    port = PPipeline(_small(p_get_preset),
                     building_provider=PStaticProvider("<osm>\n</osm>"),
                     base_T=np.eye(4), device="cpu")
    ref_frames, port_frames = [], []
    for fr in frames:
        # both backends drop keyframes until the first GPS fix has made
        # their building manager
        ref.on_gps(fr.stamp, *fr.gps)
        port.on_gps(fr.stamp, *fr.gps)
        ref_frames.append(ref.on_points(fr.stamp, fr.points))
        port_frames.append(port.on_points(fr.stamp, fr.points))
    # interval 2.0 s > 1.1 s of stamps: no update step has fired yet
    assert not ref.backend.graph.edges and not port.backend.graph.edges
    ref.backend.flush_keyframe_queue()
    port.backend.flush_keyframe_queue()
    return ref, port, ref_frames, port_frames, [0] + ref_iters


def test_odometry_poses_match_reference(runs):
    ref, port, ref_frames, port_frames, ref_iters = runs
    eps = port.cfg.odometry.registration.transformation_epsilon
    same_iters = 0
    for k, (fr, fp) in enumerate(zip(ref_frames, port_frames)):
        assert fr.converged and fp.converged, k
        dt = np.abs(fp.pose[:3, 3] - fr.pose[:3, 3]).max()
        da = _rot_angle(fp.pose, fr.pose)
        if fp.iterations == ref_iters[k]:
            same_iters += 1
            # same GN path: within 1e-2 m and 1e-3 rad (float32 sums in
            # another order, and plane covariances of <3-point windows
            # whose normal float32 rounding decides)
            assert dt < 1e-2 and da < 1e-3, (k, dt, da)
        else:
            # one more or one fewer GN step: the step that stopped the
            # loop is below transformation_epsilon, so that bounds the gap
            assert dt < eps and da < eps, (k, dt, da)
    assert same_iters >= N_FRAMES - 2
    assert np.linalg.norm(port_frames[-1].pose[:3, 3]) > 3.0  # it moved


def test_keyframes_and_edges_match_reference(runs):
    ref, port, _, _, _ = runs
    assert len(port.backend.new_keyframes) == len(ref.backend.new_keyframes) >= 3
    r_edges = [e for e in ref.backend.graph.edges if e["type"] == "se2"]
    p_edges = port.backend.graph.edges
    assert len(p_edges) == len(r_edges)
    for er, ep in zip(r_edges, p_edges):
        assert (ep["i"], ep["j"], ep["level"]) == (er["i"], er["j"], er["level"])
        # rel2d at rtol 1e-3, with the pose tolerances as the floor for
        # the near-zero lateral and yaw components
        floor = np.array([1e-2, 1e-2, 1e-3])
        gap = np.abs(ep["meas"] - er["meas"])
        assert np.all(gap <= 1e-3 * np.abs(er["meas"]) + floor), (gap, er["meas"])
        np.testing.assert_allclose(ep["info"], er["info"], rtol=1e-3)
    np.testing.assert_allclose(port.backend.poses, ref.backend.poses,
                               rtol=1e-3, atol=1e-2)


def test_pipeline_finish_and_timing():
    _, frames = p_kitti.synthetic_city_sequence(n_frames=6, speed=3.0)
    cfg = _small(p_get_preset)
    cfg = dataclasses.replace(cfg, delta=dataclasses.replace(
        cfg.delta, keyframe_delta_trans=0.5, max_keyframes_per_update=1))
    pipe = PPipeline(cfg, building_provider=PStaticProvider("<osm></osm>"),
                     device="cpu")
    for fr in frames:
        pipe.on_gps(fr.stamp, *fr.gps)
        pipe.on_points(fr.stamp, fr.points)
    assert len(pipe.backend.keyframe_queue) == 3
    stats = pipe.finish()                        # three flushes of one
    assert len(pipe.backend.keyframes) == 3
    assert stats["loops"] == 0 and np.isfinite(stats["chi2_level0"])
    assert not pipe.backend.keyframe_queue
    edges = pipe.backend.graph.edges
    assert [(e["i"], e["j"]) for e in edges] == [(1, 0), (2, 0), (3, 2)]
    assert all(np.isfinite(e["info"]).all() for e in edges)
    t = pipe.timing_summary()
    for stage in ("prefiltering", "odometry", "backend_enqueue",
                  "backend.information_matrix", "backend.optimize_level0"):
        assert t[stage]["count"] > 0, stage


def test_cuda_request_without_card_raises(monkeypatch):
    """No carrying on on the CPU when the card is missing."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        PPipeline(p_get_preset("delta"), device="cuda")


def _default_device_constructors():
    from delta_graph_slam_tpu_torch.buildings import BuildingManager
    from delta_graph_slam_tpu_torch.graph import SE2GraphBuilder
    from delta_graph_slam_tpu_torch.lines import LineBasedScanmatcher
    from delta_graph_slam_tpu_torch.models.delta_backend import DeltaBackend
    from delta_graph_slam_tpu_torch.models.prefiltering import PrefilteringStage
    from delta_graph_slam_tpu_torch.models.scan_matching_odometry import (
        ScanMatchingOdometry,
    )

    cfg = p_get_preset("delta")
    return {
        "Pipeline": lambda: PPipeline(cfg, building_provider=PStaticProvider("<osm></osm>")),
        "PrefilteringStage": lambda: PrefilteringStage(cfg.prefiltering),
        "ScanMatchingOdometry": lambda: ScanMatchingOdometry(cfg.odometry),
        "DeltaBackend": lambda: DeltaBackend(cfg.delta, PStaticProvider("<osm></osm>")),
        "BuildingManager": lambda: BuildingManager(PStaticProvider("<osm></osm>"),
                                                   np.zeros(3), 1.0),
        "LineBasedScanmatcher": lambda: LineBasedScanmatcher(cfg.delta.scanmatcher),
        "SE2GraphBuilder": lambda: SE2GraphBuilder(),
    }


@pytest.mark.parametrize("name", ["Pipeline", "PrefilteringStage",
                                  "ScanMatchingOdometry", "DeltaBackend",
                                  "BuildingManager", "LineBasedScanmatcher",
                                  "SE2GraphBuilder"])
def test_entry_points_default_to_the_card(monkeypatch, name):
    """Every stage runs on the card unless the caller names the CPU: with
    no device given and no card, construction raises."""
    from delta_graph_slam_tpu_torch.utils.device import DEFAULT_DEVICE

    assert DEFAULT_DEVICE == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        _default_device_constructors()[name]()


def test_config_from_reference_fields():
    ref = r_get_preset("delta")
    port = config_from_reference_fields(dataclasses.asdict(ref))
    assert port == p_get_preset("delta")        # the same launch values
    with pytest.raises(KeyError):
        config_from_reference_fields({"name": "delta"})


def test_cloud_interop_round_trip():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    mask = rng.random(50) > 0.3
    back_pts, back_mask = cloud_to_numpy(cloud_from_numpy(pts, mask))
    np.testing.assert_array_equal(back_pts, pts)
    np.testing.assert_array_equal(back_mask, mask)


@pytest.mark.parametrize("seed", [0, 3])
def test_scan_sources_are_byte_identical(seed):
    rw = r_kitti.make_city_world(seed=seed)
    pw = p_kitti.make_city_world(seed=seed)
    assert rw.osm_xml() == pw.osm_xml()
    for a, b in ((rw.wall_pts, pw.wall_pts), (rw.ground_pts, pw.ground_pts)):
        assert a.tobytes() == b.tobytes()
    pose = np.array([-40.0, 1.0, 0.2])
    assert (r_lidar_sim.raycast_scan(rw, pose, seed=seed).tobytes()
            == p_lidar_sim.raycast_scan(pw, pose, seed=seed).tobytes())
    _, rf = r_lidar_sim.raycast_city_sequence(n_frames=2, seed=seed)
    _, pf = p_lidar_sim.raycast_city_sequence(n_frames=2, seed=seed)
    _, rs = r_kitti.synthetic_city_sequence(n_frames=2, seed=seed)
    _, ps = p_kitti.synthetic_city_sequence(n_frames=2, seed=seed)
    for a, b in zip(rf + rs, pf + ps):
        assert a.points.tobytes() == b.points.tobytes()
        assert a.gt_pose.tobytes() == b.gt_pose.tobytes()
        assert (a.stamp, a.gps) == (b.stamp, b.gps)


def test_port_imports_no_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "import delta_graph_slam_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')\n"
        "       or n.startswith('delta_graph_slam_tpu.')\n"
        "       or n == 'delta_graph_slam_tpu']\n"
        "assert not bad, bad\n"
        "print('ok', len([n for n in sys.modules if n.startswith(p.__name__)]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
