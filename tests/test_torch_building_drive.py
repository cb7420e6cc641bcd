"""The port's delta backend with OSM buildings on, against the JAX package's:
the drift lap of tests/test_torch_backend.py (the same prefiltered clouds
to both packages) driven with the city's buildings, plus one building that
overlaps its neighbour so that every cycle runs de-overlap rounds. The
port's RANSAC replays the JAX package's random stream (JaxSampler), and
the scan matcher runs at small_delta_cfg's sizes. Loop closure is on, as
in the drift lap of tests/test_torch_backend.py, so loop edges share the
level-0 and level-1 solves with the building edges.
"""

import dataclasses

import numpy as np
import pytest
import torch

from delta_graph_slam_tpu import ops as r_ops
from delta_graph_slam_tpu.buildings import StaticProvider as RStatic
from delta_graph_slam_tpu.geom.host import se2_compose_np, transform_2d_to_3d_np
from delta_graph_slam_tpu.io.pcd import load_pcd as r_load_pcd
from delta_graph_slam_tpu.models.delta_backend import DeltaBackend as RBackend
from delta_graph_slam_tpu.pipeline.keyframe import KeyFrameSnapshot as RSnapshot
from delta_graph_slam_tpu.pipeline.map_cloud_generator import MapCloudGenerator as RMapGen
from delta_graph_slam_tpu_torch.buildings import StaticProvider
from delta_graph_slam_tpu_torch.interop import (
    cloud_from_numpy, cloud_to_numpy, config_from_reference_fields,
)
from delta_graph_slam_tpu_torch.models.delta_backend import DeltaBackend, DeltaBackendConfig
from test_torch_backend import _small_delta_reference, drift_lap  # noqa: F401 (fixture)
from test_torch_lines import JaxSampler

torch.set_num_threads(2)


def _overlapping_world(world, frames):
    """The world plus a copy of the building nearest the start, shifted
    by (2, 1) m so that the two overlap."""
    start = frames[0].gt_pose[:2]
    near = min(world.buildings, key=lambda r: np.linalg.norm(r.mean(0) - start))
    return dataclasses.replace(world, buildings=list(world.buildings) + [near + [2.0, 1.0]])


def _delta_config():
    _, delta = _small_delta_reference()
    sm = dataclasses.replace(delta.scanmatcher, max_lines=12, max_target_lines=32,
                             edge_capacity=48, target_edge_capacity=64, score_chunk=64,
                             n_hypotheses=128, cloud_chunk=512, min_cluster_size=20)
    return dataclasses.replace(delta, scanmatcher=sm, enable_buildings=True,
                               distance_thresh=6.0, accum_distance_thresh=6.0,
                               min_edge_interval=3.0, fitness_score_thresh=1.0)


def _drive(world, frames, gts, clouds, port):
    delta = _delta_config()
    if port:
        be = DeltaBackend(config_from_reference_fields(dataclasses.asdict(delta),
                                                       DeltaBackendConfig),
                          StaticProvider(world.osm_xml()))
        be.scanmatcher.sampler = JaxSampler()
    else:
        be = RBackend(delta, RStatic(world.osm_xml()))
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


@pytest.fixture(scope="module")
def building_runs(drift_lap):  # noqa: F811 (the imported fixture)
    world, frames, gts, clouds = drift_lap
    world = _overlapping_world(world, frames)
    ref, r_steps = _drive(world, frames, gts, clouds, port=False)
    port, p_steps = _drive(world, frames, gts, clouds, port=True)
    return ref, r_steps, port, p_steps


def test_building_drive_matches_reference(building_runs):
    ref, r_steps, port, p_steps = building_runs
    assert [k.stamp for k in port.keyframes] == [k.stamp for k in ref.keyframes]
    assert [k.node_id for k in port.keyframes] == [k.node_id for k in ref.keyframes]
    pb, rb = port.buildings_manager.buildings, ref.buildings_manager.buildings
    assert [(b.id, b.node_id) for b in pb] == [(b.id, b.node_id) for b in rb]
    # the same edge list, informations within rtol 1e-3
    key = ("type", "i", "j", "level")
    assert [tuple(e[k] for k in key) for e in port.graph.edges] == [
        tuple(e[k] for k in key) for e in ref.graph.edges]
    for ep, er in zip(port.graph.edges, ref.graph.edges):
        np.testing.assert_allclose(ep["info"], er["info"], rtol=1e-3)
    # every building path ran: keyframe<->building edges, global priors,
    # de-overlap edges
    levels = {(e["type"], e["level"]) for e in port.graph.edges}
    assert {("se2", 1), ("se2", 2), ("xy", 0), ("yaw", 0)} <= levels
    assert len(p_steps) == len(r_steps) >= 3
    for (sp, pp), (sr, pr) in zip(p_steps, r_steps):
        assert sp["deoverlap_rounds"] == sr["deoverlap_rounds"]
        assert np.isfinite(sp["chi2_level0"]) and np.isfinite(sp["chi2_level1"])
        # the registration bound of tests/test_torch_pipeline.py: 1e-2 m, 1e-3 rad
        assert np.abs(pp[:, :2] - pr[:, :2]).max() < 1e-2
        assert np.abs(pp[:, 2] - pr[:, 2]).max() < 1e-3
    assert sum(s["deoverlap_rounds"] for s, _ in p_steps) >= 1
    assert sum(s["loops"] for s, _ in p_steps) == sum(s["loops"] for s, _ in r_steps) >= 1
    m_p, m_r = port.compute_ate_rpe(), ref.compute_ate_rpe()
    assert abs(m_p["ATE_mean"] - m_r["ATE_mean"]) < 1e-2
    # the edge-type counts of tests/test_pipeline_e2e.py:110-124
    types = {}
    for e in port.graph.edges:
        types[e["type"]] = types.get(e["type"], 0) + 1
    assert types.get("se2", 0) >= 2 and types.get("xy", 0) >= 1 and types.get("yaw", 0) >= 1


def test_save_map_matches_reference(building_runs, tmp_path):
    """save_map writes map.pcd, b_map.pcd and aligned_b_map.pcd, which the
    JAX package's load_pcd reads back with the reference's point counts."""
    ref, _, port, _ = building_runs
    assert port.save_map(tmp_path / "port", resolution=0.2)
    assert ref.save_map(str(tmp_path / "ref"), resolution=0.2)
    counts = {}
    for name in ("map.pcd", "b_map.pcd", "aligned_b_map.pcd"):
        got = r_load_pcd(tmp_path / "port" / name)
        want = r_load_pcd(tmp_path / "ref" / name)
        assert got.shape[1] == 3 and len(got) > 100 and np.isfinite(got).all()
        counts[name] = (len(got), len(want))
    assert counts["b_map.pcd"][0] == counts["b_map.pcd"][1]
    assert counts["aligned_b_map.pcd"][0] == counts["aligned_b_map.pcd"][1]
    # the map: the reference's generator on the port's snapshots gives the
    # port's count exactly; the reference's own run (poses within ~1e-3 m)
    # within 0.1%
    snaps = [RSnapshot(pose=s.pose, cloud=r_ops.make_cloud(*cloud_to_numpy(s.cloud)))
             for s in port.snapshots]
    assert counts["map.pcd"][0] == len(RMapGen().generate(snaps, 0.2))
    assert abs(counts["map.pcd"][0] - counts["map.pcd"][1]) <= 1e-3 * counts["map.pcd"][1]
