"""The port's line-feature matcher (ops/ransac.py, lines/*) against the JAX
package's, on the same numpy inputs.

RANSAC samples: the port takes its uniforms from a sampler, and
``JaxSampler`` replays the JAX package's threefry stream (PRNGKey(7),
split once per extraction, then once per line), so both packages fit the
same hypotheses. Sizes are those of tests/test_lines.py:146-151 and of
small_delta_cfg (tests/test_pipeline_e2e.py:36-57).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delta_graph_slam_tpu import lines as RL
from delta_graph_slam_tpu import ops as r_ops
from delta_graph_slam_tpu.config import get_preset as r_get_preset
from delta_graph_slam_tpu.geom.interpolate import interpolate_segment as r_interpolate
from delta_graph_slam_tpu.io.kitti import make_city_world
from delta_graph_slam_tpu.io.lidar_sim import LidarModel, raycast_scan
from delta_graph_slam_tpu.lines.scoring import fitness_core as r_fitness_core
from delta_graph_slam_tpu.models.prefiltering import PrefilteringStage as RPrefilter
from delta_graph_slam_tpu.ops import ransac as r_ransac
from delta_graph_slam_tpu_torch import lines as PL
from delta_graph_slam_tpu_torch.geom.host import se2_inverse_np, transform_2d_to_3d_np
from delta_graph_slam_tpu_torch.geom.interpolate import interpolate_segment
from delta_graph_slam_tpu_torch.interop import cloud_from_numpy, cloud_to_numpy
from delta_graph_slam_tpu_torch.lines.scoring import fitness_core
from delta_graph_slam_tpu_torch.ops import ransac

torch.set_num_threads(2)


class JaxSampler:
    """The JAX package's RANSAC stream as uniforms for the port
    (lines/align.py:418-434, ops/ransac.py:32-35, :260), in JAX's default
    float dtype (float64 here, where conftest.py turns x64 on, as the
    reference draws in this process) or in ``dtype``."""

    def __init__(self, seed=7, dtype=None):
        self.key = jax.random.PRNGKey(seed)
        self.dtype = dtype

    def __call__(self, n_lines, n_hypotheses):
        self.key, sub = jax.random.split(self.key)
        kw = {} if self.dtype is None else {"dtype": self.dtype}
        return np.stack([np.asarray(jax.random.uniform(k, (n_hypotheses, 2), **kw))
                         for k in jax.random.split(sub, n_lines)])


def small_scanmatcher_reference():
    """small_delta_cfg's scan-matcher sizes (tests/test_pipeline_e2e.py:45-50)."""
    cfg = r_get_preset("delta").delta.scanmatcher
    return dataclasses.replace(cfg, max_lines=12, max_target_lines=32, edge_capacity=48,
                               target_edge_capacity=64, score_chunk=64, n_hypotheses=128,
                               cloud_chunk=512, min_cluster_size=20)


def test_cfg():
    """tests/test_lines.py:146-151."""
    return RL.LineScanmatcherConfig(max_lines=8, max_target_lines=16, edge_capacity=32,
                                    target_edge_capacity=32, score_chunk=64,
                                    n_hypotheses=128, cloud_chunk=128)


test_cfg.__test__ = False


def port_cfg(ref_cfg):
    return PL.LineScanmatcherConfig(**dataclasses.asdict(ref_cfg))


def square(cx=0.0, cy=0.0, half=5.0):
    p = np.array([[-half, -half], [half, -half], [half, half], [-half, half]]) + [cx, cy]
    return p, np.roll(p, -1, axis=0)


def both_lines(a, b, cap):
    """(reference, port) LineSegments of the same float32 endpoints."""
    return RL.make_lines(a, b, capacity=cap), PL.make_lines(a, b, capacity=cap)


@pytest.mark.parametrize("degenerate", [False, True])
def test_line_segments_capacity_lengths_directions_match_reference(degenerate):
    """LineSegments.capacity, .lengths() and .directions() (reference
    ops/ransac.py:220-229), a zero-length segment among them when
    ``degenerate``."""
    rng = np.random.default_rng(11)
    a = rng.uniform(-30, 30, (9, 2)).astype(np.float32)
    b = (a + rng.normal(0, 5, (9, 2))).astype(np.float32)
    if degenerate:
        b[4] = a[4]
    r, p = both_lines(a, b, 12)
    assert p.capacity == r.capacity == 12
    # one float32 norm: within 1 ulp-scale of the length
    np.testing.assert_allclose(p.lengths().numpy(), np.asarray(r.lengths()), rtol=1e-6)
    np.testing.assert_allclose(p.directions().numpy(), np.asarray(r.directions()),
                               rtol=1e-6, atol=1e-7)


def np_(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def random_lines(rng, n, cap, spread=10.0):
    a = rng.uniform(-spread, spread, (n, 2))
    ang = rng.choice([0.0, np.pi / 2, np.pi / 3, rng.uniform(0, np.pi)], n)
    ang = ang + rng.normal(0, 0.02, n)
    ln = rng.uniform(0.5, 8.0, n)
    b = a + ln[:, None] * np.stack([np.cos(ang), np.sin(ang)], 1)
    return both_lines(a, b, cap)


# ------------------------------------------------------------------ RANSAC

@pytest.fixture(scope="module")
def flat_scan():
    """A raycast keyframe's 2-D wall cloud through the reference
    prefilter (filtered2d), and the city world it came from."""
    world = make_city_world(seed=0)
    model = LidarModel(n_beams=32, azimuth_step_deg=1.0, dropout=0.05)
    pose = np.array([-40.0, 0.5, 0.0])
    pts = raycast_scan(world, pose, model=model, seed=0)
    pre = dataclasses.replace(r_get_preset("delta").prefiltering, raw_capacity=16384,
                              out_capacity=4096, chunk=1024, neighbor_method="voxel")
    flat = cloud_to_numpy(RPrefilter(pre).process(pts).filtered2d)
    return world, pose, flat


def test_ransac_line_matches_reference(flat_scan):
    _, _, flat = flat_scan
    cfg = small_scanmatcher_reference()
    key = jax.random.PRNGKey(7)
    u = JaxSampler()(cfg.max_lines, cfg.n_hypotheses)   # split as line_extraction does
    _, sub = jax.random.split(key)
    kw = dict(dist_thresh=cfg.sac_distance_threshold, min_cluster_size=cfg.min_cluster_size,
              max_cluster_size=cfg.max_cluster_size, cluster_tolerance=cfg.cluster_tolerance,
              merror_threshold=cfg.merror_threshold, length_threshold=cfg.line_length_threshold)
    ref = r_ransac.ransac_line(r_ops.make_cloud(*flat), sub, max_lines=cfg.max_lines,
                               n_hypotheses=cfg.n_hypotheses, chunk=cfg.cloud_chunk, **kw)
    got = ransac.ransac_line(cloud_from_numpy(*flat), torch.from_numpy(u), **kw)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    assert got.mask.sum() >= 3
    for f in ("a", "b"):                      # endpoints within 1e-4 m
        np.testing.assert_allclose(np_(getattr(got, f)), np_(getattr(ref, f)), rtol=0, atol=1e-4)
    for f in ("mean_error", "std_sigma", "max_error", "min_error"):   # within 1e-5
        np.testing.assert_allclose(np_(getattr(got, f)), np_(getattr(ref, f)), rtol=0, atol=1e-5)


GAP_CASES = {
    # two runs of equal size: the first wins
    "tie": ([0.0, 0.5, 1.0, 5.0, 5.5, 6.0], [1, 1, 1, 1, 1, 1]),
    # gaps of exactly the tolerance stay joined (gap > tol splits)
    "gap_at_tolerance": ([0.0, 1.0, 2.0, 3.5, 4.0], [1, 1, 1, 1, 1]),
    "holes_and_ties": ([3.0, -1.0, 0.0, 9.0, 3.0, 7.5, 8.0, 0.5], [1, 0, 1, 1, 1, 1, 1, 0]),
    "nothing_valid": ([1.0, 2.0, 3.0], [0, 0, 0]),
}


@pytest.mark.parametrize("case", list(GAP_CASES) + ["random"])
def test_line_gap_cluster_mask_matches_reference(case):
    if case == "random":
        rng = np.random.default_rng(4)
        t = np.round(rng.uniform(-20, 20, 300), 1).astype(np.float32)   # many ties
        m = rng.random(300) > 0.3
    else:
        t, m = np.asarray(GAP_CASES[case][0], np.float32), np.asarray(GAP_CASES[case][1], bool)
    ref = r_ransac.line_gap_cluster_mask(jnp.asarray(t), jnp.asarray(m), 1.0)
    got = ransac.line_gap_cluster_mask(torch.from_numpy(t), torch.from_numpy(m), 1.0)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


# ----------------------------------------------------------------- features

def test_triu_indices_order_matches_jax():
    for L in (2, 5, 16):
        ii, jj = jnp.triu_indices(L, k=1)
        np.testing.assert_array_equal(torch.triu_indices(L, L, 1).numpy(),
                                      np.stack([np.asarray(ii), np.asarray(jj)]))


@pytest.mark.parametrize("n_dims", [3, 4])
def test_make_and_transform_lines_match_reference(n_dims):
    r, p = random_lines(np.random.default_rng(1), 6, 8)
    T = transform_2d_to_3d_np([1.5, -2.0, 0.4])
    if n_dims == 3:
        T = T[[0, 1, 3]][:, [0, 1, 3]]
    rt, pt = RL.transform_lines(r, T), PL.transform_lines(p, T)
    np.testing.assert_array_equal(pt.mask.numpy(), np.asarray(rt.mask))
    for f in ("a", "b"):
        np.testing.assert_allclose(np_(getattr(pt, f)), np_(getattr(rt, f)), rtol=0, atol=1e-5)


def _edge_inputs(case):
    if case == "square":
        return both_lines(*square(), 16)
    rng = np.random.default_rng({"random_a": 2, "random_b": 3}[case])
    return random_lines(rng, 12, 16)


@pytest.mark.parametrize("case", ["square", "random_a", "random_b"])
@pytest.mark.parametrize("angular", [False, True])
def test_edge_extraction_matches_reference(case, angular):
    r, p = _edge_inputs(case)
    kw = dict(only_angular_edges=angular, max_dist_angular_edge=2.0, capacity=48)
    er, ep = RL.edge_extraction(r, **kw), PL.edge_extraction(p, **kw)
    # masks and the compaction order exactly, values within 1e-5
    np.testing.assert_array_equal(ep.mask.numpy(), np.asarray(er.mask))
    for f in ("corner", "a", "b"):
        np.testing.assert_allclose(np_(getattr(ep, f)), np_(getattr(er, f)), rtol=0, atol=1e-5)
    if case == "square":
        assert int(ep.mask.sum()) == 4


def test_align_edges_and_lines_pair_match_reference():
    rng = np.random.default_rng(5)
    x = rng.uniform(-10, 10, (6, 64, 2)).astype(np.float32)
    Rr, tr = RL.align_edges(*map(jnp.asarray, x))
    Rp, tp = PL.align_edges(*map(torch.from_numpy, x))
    np.testing.assert_allclose(Rp.numpy(), np.asarray(Rr), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(tr), rtol=0, atol=1e-4)
    Rr, tr = RL.align_lines_pair(*map(jnp.asarray, x[:4]))
    Rp, tp = PL.align_lines_pair(*map(torch.from_numpy, x[:4]))
    np.testing.assert_allclose(Rp.numpy(), np.asarray(Rr), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tp.numpy(), np.asarray(tr), rtol=0, atol=1e-4)


# ------------------------------------------------------------------ scoring

L2L_CASES = {
    # tests/test_lines.py:71-99
    "full_coverage": ([0.0, 1.0], [4.0, 1.0], [-1.0, 0.0], [6.0, 0.0]),
    "no_overlap": ([10.0, 1.0], [14.0, 1.0], [0.0, 0.0], [5.0, 0.0]),
    "partial": ([2.0, 1.0], [8.0, 1.0], [0.0, 0.0], [5.0, 0.0]),
}


def _assert_fs_close(got, ref, tol=1e-5):
    for f in ref._fields:
        r, p = np_(getattr(ref, f)), np_(getattr(got, f))
        np.testing.assert_array_equal(np.isfinite(p), np.isfinite(r), err_msg=f)
        fin = np.isfinite(r)
        np.testing.assert_allclose(p[fin], r[fin], rtol=tol, atol=tol, err_msg=f)


@pytest.mark.parametrize("case", list(L2L_CASES) + ["random"])
def test_line_to_line_distance_matches_reference(case):
    if case == "random":
        x = np.random.default_rng(6).uniform(-6, 6, (4, 40, 50, 2)).astype(np.float32)
        x[0] = x[0][:, :1]
        x[1] = x[1][:, :1]
    else:
        x = np.asarray(L2L_CASES[case], np.float32)
    ref = RL.line_to_line_distance(*map(jnp.asarray, x))
    got = PL.line_to_line_distance(*map(torch.from_numpy, x))
    _assert_fs_close(got, ref)


@pytest.mark.parametrize("is_local", [False, True])
def test_fitness_nearest_neighbor_and_weight_match_reference(is_local):
    rng = np.random.default_rng(7)
    rs, ps = random_lines(rng, 10, 12)
    rt, pt = random_lines(rng, 14, 16)
    # a batch of candidate placements of the source, as the chunked scoring
    # builds them
    off = rng.normal(0, 0.5, (5, 1, 2)).astype(np.float32)
    sa, sb = np_(ps.a)[None] + off, np_(ps.b)[None] + off
    for max_range in (np.inf, 2.0):
        ref = r_fitness_core(jnp.asarray(sa), jnp.asarray(sb), rs.mask, rt, is_local, max_range)
        got = fitness_core(torch.from_numpy(sa), torch.from_numpy(sb), ps.mask, pt, is_local,
                           max_range)
        _assert_fs_close(got, ref)
    _assert_fs_close(PL.calc_fitness_score(ps, pt, is_local), RL.calc_fitness_score(rs, rt, is_local))
    order_r, fs_r, v_r = RL.nearest_neighbor(rs, rt)
    order_p, fs_p, v_p = PL.nearest_neighbor(ps, pt)
    np.testing.assert_array_equal(v_p.numpy(), np.asarray(v_r))
    np.testing.assert_array_equal(order_p.numpy()[v_p.numpy()], np.asarray(order_r)[np.asarray(v_r)])
    d = np.array([0.1, 2.0, 9.0, np.inf], np.float32)
    c = np.array([10.0, 50.0, 0.0, 80.0], np.float32)
    t = np.array([0.0, 1.0, 7.0, 0.3], np.float32)
    np.testing.assert_allclose(
        PL.weight_score(*map(torch.from_numpy, (d, c, t)), 1.5, 0.5, 0.5, 3.5, 3.5).numpy(),
        np.asarray(RL.weight_score(*map(jnp.asarray, (d, c, t)), 1.5, 0.5, 0.5, 3.5, 3.5)),
        rtol=1e-6, atol=1e-5)


OVERLAP_CASES = {
    # tests/test_lines.py:125-142
    "overlapping": ((0.0, 0.0), (4.0, 0.0)),
    "separated": ((0.0, 0.0), (20.0, 0.0)),
    "touching": ((0.0, 0.0), (10.0, 0.0)),
    "corner": ((0.0, 0.0), (9.0, 9.5)),
}


def test_are_buildings_overlapped_matches_reference():
    out_r, out_p = [], []
    for ca, cb in OVERLAP_CASES.values():
        (ra, pa), (rb, pb) = both_lines(*square(*ca), 8), both_lines(*square(*cb), 8)
        args_r = (ra.a, ra.b, ra.mask, jnp.asarray(ca), rb.a, rb.b, rb.mask, jnp.asarray(cb))
        args_p = (pa.a, pa.b, pa.mask, torch.tensor(ca), pb.a, pb.b, pb.mask, torch.tensor(cb))
        out_r.append(bool(RL.are_buildings_overlapped(*args_r)))
        out_p.append(bool(PL.are_buildings_overlapped(*args_p)))
    assert out_p == out_r == [True, False, False, True]
    # random polygons, batched over pairs
    rng = np.random.default_rng(8)
    x = rng.uniform(-8, 8, (4, 32, 6, 2)).astype(np.float32)
    m = rng.random((2, 32, 6)) > 0.2
    c = rng.uniform(-2, 2, (2, 32, 2)).astype(np.float32)
    ref = RL.are_buildings_overlapped(x[0], x[1], m[0], c[0], x[2], x[3], m[1], c[1])
    got = PL.are_buildings_overlapped(*map(torch.from_numpy, (x[0], x[1], m[0], c[0],
                                                              x[2], x[3], m[1], c[1])))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


MERGE_CASES = {
    # tests/test_lines.py:109-122, plus a chain that merges twice
    "collinear": ([[0.0, 0.0], [5.1, 0.0]], [[5.0, 0.0], [9.0, 0.0]]),
    "perpendicular": ([[0.0, 0.0], [0.0, 0.0]], [[5.0, 0.0], [0.0, 5.0]]),
    "chain": ([[0.0, 0.0], [4.1, 0.0], [8.2, 0.0], [0.0, 3.0]],
              [[4.0, 0.0], [8.0, 0.0], [12.0, 0.0], [0.0, 9.0]]),
}


@pytest.mark.parametrize("case", list(MERGE_CASES))
def test_merge_lines_matches_reference(case):
    a, b = (np.asarray(x) for x in MERGE_CASES[case])
    ra, rb = RL.merge_lines(a, b)
    pa, pb = PL.merge_lines(a, b)
    np.testing.assert_array_equal(pa, ra)
    np.testing.assert_array_equal(pb, rb)


def test_interpolate_segment_matches_reference():
    rng = np.random.default_rng(9)
    a = rng.uniform(-30, 30, (5, 3)).astype(np.float32)
    b = (a + rng.uniform(-12, 12, (5, 3))).astype(np.float32)
    rp, rm = r_interpolate(jnp.asarray(a), jnp.asarray(b), capacity=819)
    pp, pm = interpolate_segment(torch.from_numpy(a), torch.from_numpy(b), capacity=819)
    np.testing.assert_array_equal(pm.numpy(), np.asarray(rm))        # identical masks
    np.testing.assert_allclose(pp.numpy(), np.asarray(rp), rtol=0, atol=1e-5)   # 1e-5 m


# --------------------------------------------------------------- alignment

def _assert_alignment_close(got, ref):
    """Rotation within 1e-4, translation within 1e-3 m, the same
    edge-aligned flag, fitness within rtol 1e-4."""
    Tr, Tp = np_(ref.transformation), np_(got.transformation)
    np.testing.assert_allclose(Tp[..., :2, :2], Tr[..., :2, :2], rtol=0, atol=1e-4)
    np.testing.assert_allclose(Tp[..., :2, 3], Tr[..., :2, 3], rtol=0, atol=1e-3)
    np.testing.assert_array_equal(np_(got.is_edge_aligned), np_(ref.is_edge_aligned))
    _assert_fs_close(got.fitness, ref.fitness, tol=1e-4)


def _square_pair(t, th=0.0, cap=8):
    a, b = square()
    R = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
    return (both_lines(a, b, 16), both_lines(a @ R.T + t, b @ R.T + t, cap))


def test_align_global_and_local_on_squares_match_reference():
    """tests/test_lines.py:153-180."""
    cfg = test_cfg()
    rsm, psm = RL.LineBasedScanmatcher(cfg), PL.LineBasedScanmatcher(port_cfg(cfg), "cpu")
    (rt, pt), (rs, ps) = _square_pair(np.array([0.8, -0.5]), np.deg2rad(10))
    ref = rsm.align_global(rs, rt, constrain_angle=True, merge_targets=False)
    got = psm.align_global(ps, pt, constrain_angle=True, merge_targets=False)
    _assert_alignment_close(got, ref)
    assert float(got.fitness.coverage_percentage) > 95.0
    (rt, pt), (rs, ps) = _square_pair(np.array([0.4, 0.3]))
    ref, got = rsm.align_local(rs, rt), psm.align_local(ps, pt)
    _assert_alignment_close(got, ref)
    assert bool(got.is_edge_aligned)
    np.testing.assert_allclose(got.transformation[:2, 3].numpy(), [-0.4, -0.3], atol=0.1)


def _city_targets(world, map_pose, cap):
    """The world's outlines within 35 m of ``map_pose``, in its sensor frame
    (delta_backend.py:381-385)."""
    a, b = [], []
    for rect in world.buildings:
        if np.min(np.linalg.norm(rect - map_pose[:2], axis=1)) < 35.0:
            a.append(rect)
            b.append(np.roll(rect, -1, axis=0))
    r, p = both_lines(np.concatenate(a)[:cap], np.concatenate(b)[:cap], cap)
    inv = transform_2d_to_3d_np(se2_inverse_np(map_pose))
    return RL.transform_lines(r, inv), PL.transform_lines(p, inv)


@pytest.mark.parametrize("constrain_angle", [True, False])
def test_align_global_on_a_keyframe_matches_reference(flat_scan, constrain_angle):
    """A keyframe's flat cloud against the city outlines seen from a map
    pose 0.6 m / 0.03 rad off the true one; RANSAC through the replayed
    stream."""
    world, pose, flat = flat_scan
    cfg = small_scanmatcher_reference()
    rsm = RL.LineBasedScanmatcher(cfg)
    psm = PL.LineBasedScanmatcher(port_cfg(cfg), "cpu", sampler=JaxSampler())
    rt, pt = _city_targets(world, pose + [0.5, -0.3, 0.03], cfg.max_target_lines)
    ref = rsm.align_global(r_ops.make_cloud(*flat), rt, constrain_angle=constrain_angle,
                           max_range=3.5)
    got = psm.align_global(cloud_from_numpy(*flat), pt, constrain_angle=constrain_angle,
                           max_range=3.5)
    np.testing.assert_array_equal(got.not_aligned_lines.mask.numpy(),
                                  np.asarray(ref.not_aligned_lines.mask))
    _assert_alignment_close(got, ref)
    assert not np.allclose(got.transformation.numpy(), np.eye(4))     # it moved


def _stack(ls, lib):
    if lib is torch:
        return type(ls[0])(*(torch.stack(f) for f in zip(*ls)))
    return jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *ls)


def test_align_local_batch_matches_reference():
    """Building outlines against scan lines, one batch of pairs with their
    frame transforms; an all-masked pair returns an exact identity."""
    cfg = test_cfg()
    rsm, psm = RL.LineBasedScanmatcher(cfg), PL.LineBasedScanmatcher(port_cfg(cfg), "cpu")
    rng = np.random.default_rng(10)
    src_r, src_p, tgt_r, tgt_p, Ts, Tt = [], [], [], [], [], []
    for k in range(4):
        a, b = square(rng.uniform(-3, 3), rng.uniform(-3, 3), rng.uniform(3, 6))
        bpose = np.array([rng.uniform(-20, 20), rng.uniform(-20, 20), 0.0])
        r, p = both_lines(a + bpose[:2], b + bpose[:2], 16)
        # the scan sees each wall in part, with noise, from a pose off by
        # a few decimetres
        f = rng.uniform(0.05, 0.3, (2, 4, 1))
        sa = a + f[0] * (b - a) + rng.normal(0, 0.02, a.shape) + bpose[:2]
        sb = b - f[1] * (b - a) + rng.normal(0, 0.02, a.shape) + bpose[:2]
        sr, sp = both_lines(sa, sb, 16)
        off = np.array([rng.normal(0, 0.3), rng.normal(0, 0.3), rng.normal(0, 0.03)])
        kf = bpose + [rng.uniform(-8, 8), rng.uniform(-8, 8), rng.uniform(-1, 1)]
        scan_T = np.linalg.inv(transform_2d_to_3d_np(kf)) @ transform_2d_to_3d_np(off)
        sr, sp = RL.transform_lines(sr, scan_T), PL.transform_lines(sp, scan_T)
        if k == 3:
            sr = sr._replace(mask=jnp.zeros_like(sr.mask))
            sp = sp._replace(mask=torch.zeros_like(sp.mask))
        src_r.append(r)
        src_p.append(p)
        tgt_r.append(sr)
        tgt_p.append(sp)
        binv = np.linalg.inv(transform_2d_to_3d_np(bpose))
        Ts.append(binv)
        Tt.append(binv @ transform_2d_to_3d_np(kf))
    Ts, Tt = np.float32(Ts), np.float32(Tt)
    ref = rsm.align_local_batch(_stack(src_r, jnp), _stack(tgt_r, jnp), Ts, Tt, 0.5)
    got = psm.align_local_batch(_stack(src_p, torch), _stack(tgt_p, torch), Ts, Tt, 0.5)
    _assert_alignment_close(got, ref)
    assert np.array_equal(got.transformation[3].numpy(), np.eye(4))   # exact identity
    assert got.is_edge_aligned[:3].any()


def test_align_overlapped_batch_matches_reference():
    """tests/test_lines.py:182-222: the batch against the reference's batch
    and the per-pair align_overlapped_buildings of both packages."""
    cfg = test_cfg()
    rsm, psm = RL.LineBasedScanmatcher(cfg), PL.LineBasedScanmatcher(port_cfg(cfg), "cpu")
    A, B, C = (both_lines(*square(*c), 8) for c in ((0, 0), (8.0, 0), (1.0, 7.0)))
    pa, pb, pc = np.zeros(3), np.array([8.0, 0.0, 0.0]), np.array([1.0, 7.0, 0.15])
    out = {}
    for k, lib in ((0, jnp), (1, torch)):
        empty = A[k]._replace(mask=lib.zeros_like(A[k].mask))
        sm = (rsm, psm)[k]
        out[k] = sm.align_overlapped_batch(
            _stack([A[k], C[k], empty], lib), _stack([B[k], A[k], empty], lib),
            np.stack([pa, pc, np.zeros(3)]), np.stack([pb, pa, np.zeros(3)]))
    (Tr, fr), (Tp, fp) = out[0], out[1]
    np.testing.assert_array_equal(fp.numpy(), np.asarray(fr))
    assert fp.tolist() == [True, True, False]
    np.testing.assert_allclose(Tp.numpy(), np.asarray(Tr), rtol=0, atol=1e-4)
    T1, f1 = psm.align_overlapped_buildings(A[1], pa, B[1], pb)
    R1, g1 = rsm.align_overlapped_buildings(A[0], pa, B[0], pb)
    assert f1 and g1
    np.testing.assert_allclose(T1, R1, rtol=0, atol=1e-4)
    np.testing.assert_allclose(Tp[0].numpy(), T1, rtol=0, atol=1e-4)
    assert abs(np.linalg.norm(T1[:2, 3]) - 2.0) < 0.5
