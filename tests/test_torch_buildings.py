"""The port's building layer (buildings/, the building information
matrices, the pose graph with building vertices, the map export helpers)
against the JAX package's, on the same numpy inputs."""

from functools import partial

import numpy as np
import pytest
import torch

from delta_graph_slam_tpu import ops as r_ops
from delta_graph_slam_tpu.buildings import BuildingManager as RManager
from delta_graph_slam_tpu.buildings import StaticProvider as RStatic
from delta_graph_slam_tpu.buildings import building_map_transform as r_building_map_transform
from delta_graph_slam_tpu.graph import SE2GraphBuilder as RBuilder
from delta_graph_slam_tpu.graph import SolverConfig as RConfig
from delta_graph_slam_tpu.graph import optimize_se2 as r_optimize
from delta_graph_slam_tpu.io.kitti import make_city_world
from delta_graph_slam_tpu.ops.voxel import occupied_voxel_centers as r_occupied
from delta_graph_slam_tpu.pipeline import InformationMatrixCalculator as RInfo
from delta_graph_slam_tpu.pipeline.keyframe import KeyFrameSnapshot as RSnapshot
from delta_graph_slam_tpu.pipeline.map_cloud_generator import MapCloudGenerator as RMapGen
from delta_graph_slam_tpu_torch.buildings import (
    BuildingManager, StaticProvider, building_map_transform,
)
from delta_graph_slam_tpu_torch.geom import projection
from delta_graph_slam_tpu_torch.graph import SE2GraphBuilder, SolverConfig, optimize_se2
from delta_graph_slam_tpu_torch.interop import cloud_from_numpy, cloud_to_numpy
from delta_graph_slam_tpu_torch.ops.voxel import occupied_voxel_centers
from delta_graph_slam_tpu_torch.pipeline.information_matrix import InformationMatrixCalculator
from delta_graph_slam_tpu_torch.pipeline.keyframe import KeyFrameSnapshot
from delta_graph_slam_tpu_torch.pipeline.map_cloud_generator import MapCloudGenerator

torch.set_num_threads(2)


def np_(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------------------ manager

def _managers(xml):
    """A reference and a port manager over the same world, each with a
    graph builder behind its callbacks, as the backends wire them
    (delta_backend.py:271-281)."""
    lat, lon = make_city_world(seed=0).origin_gps
    scale = float(projection.mercator_scale(lat))
    origin = np.asarray(projection.mercator_from_gps(np.float64(lat), np.float64(lon), 0.0,
                                                     scale=scale))
    out = []
    for Mgr, Prov, Builder in ((RManager, RStatic, RBuilder),
                               (partial(BuildingManager, device="cpu"), StaticProvider,
                                partial(SE2GraphBuilder, device="cpu"))):
        g = Builder()
        mgr = Mgr(Prov(xml), origin, scale,
                  graph_add_vertex=g.add_vertex,
                  graph_add_prior_xy=lambda v, xy, w, g=g: g.add_prior_xy(
                      v, xy, np.eye(2) * w, level=1),
                  graph_add_prior_yaw=lambda v, yaw, w, g=g: g.add_prior_yaw(v, yaw, w, level=1),
                  synchronous=True)
        out.append((mgr, g))
    return out


def test_new_building_matches_reference():
    """Buildings made along the street (building_tools.cpp:137-196): ids,
    poses, corners, outline lines, the 2 cm cloud and the graph vertex with
    its two level-1 priors."""
    world = make_city_world(seed=0)
    (rm, rg), (pm, pg) = _managers(world.osm_xml())
    lat, lon = world.origin_gps
    seen = []
    for dlon in (0.0, 3e-4, 6e-4):
        got = pm.get_buildings(lat, lon + dlon)
        want = rm.get_buildings(lat, lon + dlon)
        assert [b.id for b in got] == [b.id for b in want]
        seen += [b.id for b in got]
    assert len(pm.buildings) >= 3 and len(set(seen)) == len(pm.buildings)
    assert [b.id for b in pm.buildings] == [b.id for b in rm.buildings]
    for p, r in zip(pm.buildings, rm.buildings):
        np.testing.assert_array_equal(p.pose, r.pose)          # host float64, same math
        np.testing.assert_array_equal(p.corners, r.corners)
        assert (p.node_id, p.prior_edge_ids) == (r.node_id, r.prior_edge_ids)
        np.testing.assert_array_equal(np_(p.lines.mask), np_(r.lines.mask))
        np.testing.assert_array_equal(np_(p.lines.a), np_(r.lines.a))
        np.testing.assert_array_equal(np_(p.lines.b), np_(r.lines.b))
        np.testing.assert_array_equal(np_(p.cloud.mask), np_(r.cloud.mask))   # identical
        np.testing.assert_allclose(np_(p.cloud.points), np_(r.cloud.points),
                                   rtol=0, atol=1e-5)                        # 1e-5 m
        assert int(np_(p.cloud.mask).sum()) > 100
    assert len(pm.get_building_nodes()) == len(rm.get_building_nodes())
    assert len(pg.poses) == len(rg.poses)
    np.testing.assert_array_equal(np.stack(pg.poses), np.stack(rg.poses))
    for ep, er in zip(pg.edges, rg.edges):
        assert ({k: ep[k] for k in ("id", "type", "i", "j", "level", "kernel")}
                == {k: er[k] for k in ("id", "type", "i", "j", "level", "kernel")})
        np.testing.assert_array_equal(ep["info"], er["info"])
        np.testing.assert_array_equal(ep["meas"], er["meas"])


def test_empty_world_yields_no_buildings():
    (rm, _), (pm, pg) = _managers("<osm></osm>")
    assert pm.get_buildings(49.01, 8.40) == rm.get_buildings(49.01, 8.40) == []
    assert not pg.poses


def test_building_map_transform_and_getters_match_reference():
    world = make_city_world(seed=0)
    (rm, rg), (pm, pg) = _managers(world.osm_xml())
    pm.get_buildings(*world.origin_gps)
    rm.get_buildings(*world.origin_gps)
    rng = np.random.default_rng(11)
    poses = np.stack(rg.poses) + rng.normal(0, [0.3, 0.3, 0.05], (len(rg.poses), 3))
    for p, r in zip(pm.buildings, rm.buildings):
        est = poses[p.node_id]
        np.testing.assert_allclose(building_map_transform(p.pose, est),
                                   r_building_map_transform(r.pose, est), rtol=0, atol=1e-12)
        for f in ("a", "b"):
            np.testing.assert_allclose(np_(getattr(p.get_lines(poses), f)),
                                       np_(getattr(r.get_lines(poses), f)), rtol=0, atol=1e-4)
        pc, rc = p.get_cloud(poses), r.get_cloud(poses)
        np.testing.assert_array_equal(np_(pc.mask), np_(rc.mask))
        np.testing.assert_allclose(np_(pc.points), np_(rc.points), rtol=0, atol=1e-4)
        np.testing.assert_allclose(p.get_points(poses), r.get_points(poses), rtol=0, atol=1e-12)
        np.testing.assert_array_equal(p.estimate(poses), r.estimate(poses))


@pytest.mark.parametrize("const", [False, True])
def test_building_information_matrices_match_reference(const):
    kw = dict(b_var_gain_a=7.0, b_max_stddev_x=2.0, b_avg_fitness_score=1.75,
              b_importance_ratio_global=500.0, b_importance_ratio_local=25.0,
              use_const_inf_matrix=const)
    p, r = InformationMatrixCalculator(**kw), RInfo(**kw)
    for fit in (0.0, 0.05, 0.3, 2.0, np.inf):
        np.testing.assert_allclose(p.calc_information_matrix_buildings_global(fit),
                                   r.calc_information_matrix_buildings_global(fit), rtol=1e-12)
    for avg, cov, edge in ((0.01, 99.0, True), (0.4, 50.0, False), (2.5, 12.0, True)):
        np.testing.assert_allclose(p.calc_information_matrix_buildings_local(avg, cov, edge),
                                   r.calc_information_matrix_buildings_local(avg, cov, edge),
                                   rtol=1e-12)


# ------------------------------------------------------- graph with buildings

def _relpose(a, b):
    c, s = np.cos(a[2]), np.sin(a[2])
    d = b[:2] - a[:2]
    return np.array([c * d[0] + s * d[1], -s * d[0] + c * d[1],
                     np.arctan2(np.sin(b[2] - a[2]), np.cos(b[2] - a[2]))])


def _building_graph(Builder):
    """The backend's vertex layout with buildings: keyframe 0, the fixed
    anchor, then building vertices interleaved between keyframes, so that
    reversed odometry edges skip over them; level-1 keyframe<->building
    edges and building priors, level-0 global priors, level-2 de-overlap
    edges of which one is removed and another added after a first pack."""
    rng = np.random.default_rng(12)
    b = Builder()
    layout = "k a B k k B k k B k k".split()
    gt, kfs, bld = [], [], []
    x = 0.0
    for tag in layout:
        if tag == "B":
            p = np.array([x + 3.0, 8.0 + len(bld), 0.0])
            bld.append(b.add_vertex(p + [0.4, -0.3, 0.05]))
            gt.append(p)
            b.add_prior_xy(bld[-1], p[:2], np.eye(2) * 0.001, level=1)
            b.add_prior_yaw(bld[-1], p[2], 0.001, level=1)
            continue
        p = np.array([x, 0.1 * x, 0.02 * x])
        v = b.add_vertex(p + (rng.normal(0, 0.05, 3) if kfs else 0), fixed=(tag == "a"))
        gt.append(p)
        if tag == "a":
            b.add_se2_edge(v, kfs[0], np.zeros(3), np.eye(3))
            continue
        if kfs:
            b.add_se2_edge(v, kfs[-1], _relpose(gt[v], gt[kfs[-1]]), np.diag([50.0, 50.0, 200.0]))
        kfs.append(v)
        x += 1.5
    for k in kfs[1::2]:
        b.add_prior_xy(k, gt[k][:2] + rng.normal(0, 0.05, 2), np.eye(2) * 0.2)
        b.add_prior_yaw(k, gt[k][2], 3.0)
    for k, v in ((kfs[1], bld[0]), (kfs[2], bld[0]), (kfs[3], bld[1]), (kfs[4], bld[1]),
                 (kfs[4], bld[2]), (kfs[5], bld[2])):
        b.add_se2_edge(k, v, _relpose(gt[k], gt[v]), np.diag([20.0, 20.0, 40.0]), level=1)
    e = b.add_se2_edge(bld[1], bld[2], _relpose(gt[bld[1]], gt[bld[2]]) + [0.0, 0.3, 0.0],
                       np.eye(3) * 1e4, level=2)
    b.add_se2_edge(bld[0], bld[1], _relpose(gt[bld[0]], gt[bld[1]]), np.eye(3) * 1e4, level=2)
    return b, e, kfs, bld, gt


def test_graph_with_building_vertices_matches_reference():
    """Chain-first tables, off-chain counts per level and the solves at
    levels 0/1/2 (keyframes free at level 0, fixed at 1 and 2, as the
    backend runs them) against the JAX builder and solver."""
    from test_torch_graph import _assert_same_solve

    (rb, re_, kfs, bld, gt), (pb, pe, _, _, _) = (_building_graph(RBuilder),
                                                  _building_graph(partial(SE2GraphBuilder,
                                                                          device="cpu")))
    for b in (rb, pb):
        b.to_arrays(chain_first=True, e_capacity=8)
    for b, e in ((rb, re_), (pb, pe)):              # a de-overlap round's edge swap
        b.remove_edge(e)
        b.add_se2_edge(bld[2], bld[1], _relpose(gt[bld[2]], gt[bld[1]]) + [0.2, 0.0, 0.0],
                       np.eye(3) * 1e4, level=2)
    want = rb.to_arrays(chain_first=True, e_capacity=8)
    got = pb.to_arrays(chain_first=True, e_capacity=8)
    for name in ("poses", "fixed", "vmask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    for table in ("edges", "priors_xy", "priors_yaw"):
        for field, val in getattr(want, table)._asdict().items():
            np.testing.assert_array_equal(getattr(getattr(got, table), field).numpy(),
                                          np.asarray(val), err_msg=f"{table}.{field}")
    # the swapped level-2 edge is in the repacked table
    lvl2 = got.edges.mask.numpy() & (got.edges.level.numpy() == 2)
    assert sorted(zip(got.edges.i.numpy()[lvl2], got.edges.j.numpy()[lvl2])) == sorted(
        [(bld[0], bld[1]), (bld[2], bld[1])])
    counts = []
    for level in (0, 1, 2):
        if level == 1:
            for k in kfs:
                rb.set_fixed(k, True)
                pb.set_fixed(k, True)
        counts.append(pb.count_offchain(level))
        assert counts[-1] == rb.count_offchain(level)
        gr = rb.to_arrays(chain_first=True, e_capacity=8)
        gp = pb.to_arrays(chain_first=True, e_capacity=8)
        cfg = dict(backend="chain", max_iterations=30)
        r_out = r_optimize(gr, level=level, config=RConfig(**cfg),
                           off_hint=rb.count_offchain(level), n_chain=gr.poses.shape[0] - 1)
        p_out = optimize_se2(gp, level=level, config=SolverConfig(**cfg),
                             off_hint=pb.count_offchain(level), n_chain=gp.poses.shape[0] - 1)
        _assert_same_solve(p_out, r_out, f"level {level}")
        assert np.all(np.isfinite(p_out[0].numpy()))
        rb.update_poses(np.asarray(r_out[0]))
        pb.update_poses(p_out[0])
    # the odometry edges skipping building vertices are off-chain at level
    # 0; with keyframes fixed, only building-building edges remain
    assert counts == [3, 0, 2]


# ------------------------------------------------------------- map export

def test_occupied_voxel_centers_match_reference():
    rng = np.random.default_rng(13)
    pts = rng.uniform(-3, 3, (3000, 3)).astype(np.float32)
    pts[:200] = np.round(pts[:200] / 0.05) * 0.05             # points on cell faces
    mask = rng.random(3000) > 0.1
    for res in (0.05, 0.2):
        want = r_occupied(r_ops.make_cloud(pts, mask), res)
        got = occupied_voxel_centers(cloud_from_numpy(pts, mask), res)
        gp, gm = cloud_to_numpy(got)
        wp, wm = cloud_to_numpy(want)
        np.testing.assert_array_equal(gm, wm)
        np.testing.assert_allclose(gp, wp, rtol=0, atol=1e-6)


def test_map_cloud_generator_matches_reference():
    rng = np.random.default_rng(14)
    snaps = []
    for k in range(4):
        pts = rng.uniform(-10, 10, (500, 3)).astype(np.float32)
        m = rng.random(500) > 0.2
        pose = np.array([1.7 * k, 0.3 * k, 0.1 * k])
        snaps.append((pose, pts, m))
    for res in (0.0, 0.1):
        want = RMapGen().generate([RSnapshot(pose=p, cloud=r_ops.make_cloud(x, m))
                                   for p, x, m in snaps], res)
        got = MapCloudGenerator().generate([KeyFrameSnapshot(pose=p, cloud=cloud_from_numpy(x, m))
                                            for p, x, m in snaps], res)
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
