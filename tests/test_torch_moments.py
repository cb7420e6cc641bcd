"""The port's masked radius moments (ops/moments.py), the 'dense' neighbour
and covariance methods built on them, and euclidean clustering, against the
JAX package on the same numpy inputs, on the CPU.

The reference compiles these inside jit on every path that runs them (the
prefilter, floor detection and registration programs), so the JAX side of
each comparison runs under ``jax.jit`` too: XLA turns its division by the
constant 1023 of morton_keys into a product with the reciprocal there, as
the port does. Inputs of the moment comparisons are perturbed so that no
pair lies within 1e-5 relative of r^2, where the float32 rounding of the
distance expansion decides.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delta_graph_slam_tpu import ops as R_ops
from delta_graph_slam_tpu.config import get_preset as r_get_preset
from delta_graph_slam_tpu.models.floor_detection import FloorDetectionConfig as RFloorConfig
from delta_graph_slam_tpu.models.floor_detection import FloorDetectionStage as RFloorStage
from delta_graph_slam_tpu.models.prefiltering import PrefilteringStage as RStage
from delta_graph_slam_tpu.ops import moments as r_moments
from delta_graph_slam_tpu.ops import normals as r_normals
from delta_graph_slam_tpu.ops import outliers as r_outliers
from delta_graph_slam_tpu.ops import ransac as r_ransac
from delta_graph_slam_tpu.ops.cloud import MaskedCloud as RCloud
from delta_graph_slam_tpu.register import Registration as RReg
from delta_graph_slam_tpu.register import covariance as r_cov
from delta_graph_slam_tpu_torch.config import get_preset as p_get_preset
from delta_graph_slam_tpu_torch.io.lidar_sim import raycast_city_sequence
from delta_graph_slam_tpu_torch.models.floor_detection import (
    FloorDetectionConfig, FloorDetectionStage,
)
from delta_graph_slam_tpu_torch.models.prefiltering import PrefilteringStage as PStage
from delta_graph_slam_tpu_torch.ops import moments, normals, outliers, ransac
from delta_graph_slam_tpu_torch.ops.cloud import MaskedCloud, make_cloud
from delta_graph_slam_tpu_torch.register import covariance
from delta_graph_slam_tpu_torch.register.engine import Registration as PReg
from test_torch_hdl import JaxFloorSampler, city_scan

torch.set_num_threads(2)
REL_MARGIN = 1e-5


def np_(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def clouds(pts, mask):
    """(reference cloud, port cloud) of the same float32 points and mask."""
    return (RCloud(jnp.asarray(pts), jnp.asarray(mask)),
            MaskedCloud(torch.from_numpy(pts), torch.from_numpy(mask)))


def clear_of_radius(pts, mask, support, smask, r2, rng):
    """Move query points until no (query, valid support) pair has a squared
    distance within REL_MARGIN relative of its r^2 (float64 distances of the
    float32 coordinates). r2: (N,) squared radii as the port rounds them."""
    pts = pts.copy()
    same = support is None
    for _ in range(50):
        sup = pts if same else support
        d2 = ((pts[:, None, :].astype(np.float64) - sup[None, :, :]) ** 2).sum(-1)
        near = np.abs(d2 - r2[:, None]) <= REL_MARGIN * r2[:, None]
        near &= mask[:, None] & smask[None, :]
        bad = near.any(1)
        if same:
            bad |= near.any(0)
        if not bad.any():
            return pts
        pts[bad] += rng.normal(0.0, 0.01, (int(bad.sum()), 3)).astype(np.float32)
    raise AssertionError("could not clear the radius boundary")


def scan_patch(n, seed, extent=(2.5, 2.5, 0.6)):
    """A ground-plus-wall patch of ``n`` points, a tenth of them masked."""
    rng = np.random.default_rng(seed)
    g = rng.uniform(-1, 1, (n, 3)) * extent
    wall = rng.random(n) < 0.3
    g[wall, 1] = 1.5 + rng.normal(0, 0.02, wall.sum())
    g[~wall, 2] = -0.5 + rng.normal(0, 0.02, (~wall).sum())
    return g.astype(np.float32), rng.random(n) > 0.1, rng


# --------------------------------------------------------------- morton keys

def test_morton_keys_match_reference():
    pts, mask, _ = scan_patch(3000, seed=1)
    rc, pc = clouds(pts, mask)
    want = np.asarray(jax.jit(r_moments.morton_keys)(rc.points, rc.mask))
    got = np_(moments.morton_keys(pc.points, pc.mask))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)             # exact, as int32
    assert (got[~mask] == np.iinfo(np.int32).max).all()   # invalid sort last
    # an explicit resolution: a traced value in the reference, so a true
    # division on both sides
    want = np.asarray(jax.jit(r_moments.morton_keys)(rc.points, rc.mask,
                                                     jnp.float32(0.013)))
    got = np_(moments.morton_keys(pc.points, pc.mask, 0.013))
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ radius moments

@pytest.mark.parametrize("per_query", [False, True], ids=["scalar", "per_query"])
@pytest.mark.parametrize("sort_queries", [True, False], ids=["sorted", "unsorted"])
def test_radius_moments_match_reference(per_query, sort_queries):
    pts, mask, rng = scan_patch(1500, seed=2)
    support, smask, _ = scan_patch(1100, seed=3)
    if per_query:    # range-adaptive radii
        radius = (0.3 + 0.1 * np.linalg.norm(pts[:, :2], axis=1)).astype(np.float32)
    else:
        radius = np.float32(0.45)
    r2 = np.broadcast_to(np.float32(radius) ** 2, (len(pts),)).astype(np.float64)
    pts = clear_of_radius(pts, mask, support, smask, r2, rng)
    rq, pq = clouds(pts, mask)
    rs, ps = clouds(support, smask)
    f = jax.jit(functools.partial(r_moments.radius_moments, chunk=512,
                                  sort_queries=sort_queries))
    want = f(rq, rs, jnp.asarray(radius))
    got = moments.radius_moments(pq, ps, torch.from_numpy(np.asarray(radius)),
                                 chunk=512, sort_queries=sort_queries)
    np.testing.assert_array_equal(np_(got.count), np.asarray(want.count))   # exact
    np.testing.assert_array_equal(np_(got.valid), np.asarray(want.valid))
    v = np.asarray(want.valid)
    assert v.sum() > 1000 and np.asarray(want.count)[v].mean() > 5
    np.testing.assert_allclose(np_(got.mean)[v], np.asarray(want.mean)[v], atol=1e-5)
    np.testing.assert_allclose(np_(got.cov)[v], np.asarray(want.cov)[v], atol=1e-5)


# ------------------------------------------------- the 'dense' methods of ops

def _self_cleared(n, seed, radius):
    pts, mask, rng = scan_patch(n, seed)
    r2 = np.full(n, np.float64(np.float32(radius) ** 2))
    return clear_of_radius(pts, mask, None, mask, r2, rng), mask


def _well_conditioned(cov, gap=0.1):
    """Neighbourhoods whose smallest eigenvalue is well separated: where
    the float32 eigenvector is defined to ~1e-5."""
    lam = np.linalg.eigvalsh(np.asarray(cov, np.float64))
    return (lam[:, 1] - lam[:, 0]) > gap * np.maximum(lam[:, 2], 1e-12)


def test_radius_outlier_removal_dense_matches_reference():
    pts, mask = _self_cleared(2000, seed=4, radius=0.3)
    pts[:40] += np.float32(20.0)                  # far, isolated points
    rc, pc = clouds(pts, mask)
    f = jax.jit(functools.partial(r_outliers.radius_outlier_removal, radius=0.3,
                                  min_neighbors=2, method="dense"))
    want = np.asarray(f(rc).mask)
    got = np_(outliers.radius_outlier_removal(pc, 0.3, 2, method="dense").mask)
    np.testing.assert_array_equal(got, want)      # the same points kept
    assert not got[:40].any() and got.sum() > 1500


def test_estimate_normals_dense_matches_reference():
    pts, mask = _self_cleared(2000, seed=5, radius=0.5)
    rc, pc = clouds(pts, mask)
    f = jax.jit(functools.partial(r_normals.estimate_normals, method="dense",
                                  radius=0.5, viewpoint=(0.0, 0.0, 1.0)))
    n_r, v_r = (np.asarray(x) for x in f(rc))
    n_p, v_p = (np_(x) for x in normals.estimate_normals(
        pc, method="dense", radius=0.5, viewpoint=(0.0, 0.0, 1.0)))
    np.testing.assert_array_equal(v_p, v_r)
    mom = moments.radius_moments(pc, pc, 0.5, chunk=2048)
    ok = v_r & _well_conditioned(np_(mom.cov))
    assert ok.sum() > 1000
    # unit normals oriented to the viewpoint, within 1e-3 where defined: the
    # covariances agree within 1e-5 (the test above), and an eigenvector
    # turns by that over its eigenvalue gap (>= 0.1 of the largest, ~0.02)
    np.testing.assert_allclose(n_p[ok], n_r[ok], atol=1e-3)


def test_dense_covariances_match_reference():
    pts, mask = _self_cleared(2000, seed=6, radius=1.0)
    f = jax.jit(functools.partial(r_cov.dense_covariances, radius=1.0, mode="plane"))
    c_r, v_r = (np.asarray(x) for x in f(jnp.asarray(pts), jnp.asarray(mask)))
    c_p, v_p = (np_(x) for x in covariance.dense_covariances(
        torch.from_numpy(pts), torch.from_numpy(mask), radius=1.0, mode="plane"))
    np.testing.assert_array_equal(v_p, v_r)
    pc = clouds(pts, mask)[1]
    mom = moments.radius_moments(pc, pc, 1.0, chunk=2048)
    ok = v_r & _well_conditioned(np_(mom.cov))
    assert ok.sum() > 1000
    # 'plane' covariances: eigenvalues [1e-3, 1, 1], so within 1e-4 where
    # the plane normal is defined
    np.testing.assert_allclose(c_p[ok], c_r[ok], atol=1e-4)


# ------------------------------------------- the stages with 'dense' methods

def _small_dense(get_preset):
    """tests/test_torch_register.py's small prefilter with dense neighbours."""
    cfg = get_preset("delta")
    return dataclasses.replace(cfg.prefiltering, raw_capacity=16384, out_capacity=4096,
                               chunk=1024, neighbor_method="dense")


@pytest.fixture(scope="module")
def frames():
    _, frames = raycast_city_sequence(n_frames=2, speed=3.0)
    return frames


@pytest.fixture(scope="module")
def dense_filtered(frames):
    """The reference's dense prefilter outputs of two frames, as numpy."""
    stage = RStage(_small_dense(r_get_preset))
    out = []
    for fr in frames:
        o = stage.process(fr.points, base_T=np.eye(4))
        out.append(tuple((np.asarray(c.points), np.asarray(c.mask))
                         for c in (o.filtered3d, o.filtered2d)))
    return out


def test_prefiltering_dense_matches_reference(frames, dense_filtered):
    stage = PStage(_small_dense(p_get_preset), device="cpu")
    for fr, ref in zip(frames, dense_filtered):
        out = stage.process(fr.points, base_T=np.eye(4))
        for (rp, rm), c in zip(ref, (out.filtered3d, out.filtered2d)):
            pp, pm = np_(c.points), np_(c.mask)
            assert pm.sum() > 100
            np.testing.assert_array_equal(pm, rm)          # the same points kept
            np.testing.assert_allclose(pp[pm], rp[rm], atol=1e-5)


def test_floor_detection_dense_matches_reference():
    kw = dict(sensor_height=1.8, floor_pts_thresh=200, capacity=8192, chunk=512,
              n_hypotheses=128, neighbor_method="dense", normal_radius=0.75)
    scan = city_scan(n=8000, seed=9)
    scan[: 4000, :2] *= np.float32(0.15)         # a dense ground patch
    want = RFloorStage(RFloorConfig(**kw)).detect(scan)
    got = FloorDetectionStage(FloorDetectionConfig(**kw), device="cpu",
                              sampler=JaxFloorSampler()).detect(scan)
    assert want is not None and got is not None
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


def test_fast_gicp_dense_covariances_match_reference(dense_filtered):
    """One FAST_GICP pair (0.3 m apart) with cov_method='dense'."""
    (tp, tm), _ = dense_filtered[0]
    (sp, sm), _ = dense_filtered[1]
    results = []
    for get_preset, reg_cls, cloud in (
        (r_get_preset, RReg, lambda p, m: R_ops.make_cloud(p, m)),
        (p_get_preset, PReg, lambda p, m: make_cloud(p, m)),
    ):
        cfg = dataclasses.replace(get_preset("delta").odometry.registration, chunk=1024,
                                  maximum_iterations=30, cov_method="dense")
        reg = reg_cls(cfg, capacity_voxels=4096)
        reg.set_target(cloud(tp, tm))
        res = reg.align(cloud(sp, sm), np.eye(4, dtype=np.float32))
        results.append((np_(res.transformation).astype(np.float64),
                        int(res.iterations), bool(res.converged)))
    (T_r, it_r, conv_r), (T_p, it_p, conv_p) = results
    assert conv_r and conv_p and it_p == it_r
    assert np.linalg.norm(T_r[:3, 3]) > 0.25     # a real 0.3 m motion
    # 2e-3 m and 2e-4 rad, twice the knn pair's bound: the scan's 3,800
    # points are one 4096-query chunk centred on the scan's centroid, so the
    # raw second moments reach ~3,600 m^2 against neighbourhood variances
    # of ~1e-2 m^2; the summation order of F^T W (the JAX package's and
    # PyTorch's float32 products) then turns the 'plane' covariances of
    # near-degenerate neighbourhoods (~500 of them) other ways, in the
    # reference's own arithmetic. The pair moves 1.0e-3 m / 1.0e-4 rad.
    np.testing.assert_allclose(T_p[:3, 3], T_r[:3, 3], atol=2e-3)
    dR = T_p[:3, :3].T @ T_r[:3, :3]
    assert np.linalg.norm(dR - dR.T) / (2 * np.sqrt(2)) < 2e-4


# ----------------------------------------------------- euclidean clustering

@pytest.mark.parametrize("case", ["chain_2cm", "blobs"])
def test_euclidean_cluster_mask_matches_reference(case):
    rng = np.random.default_rng(11)
    if case == "chain_2cm":
        # a 6 m chain of points 2 cm apart beside a compact blob of fewer
        # points: min-label propagation must carry the label along the chain
        chain = np.stack([np.arange(300) * 0.02, np.zeros(300), np.zeros(300)], 1)
        blob = rng.normal([10.0, 0.0, 0.0], 0.05, (200, 3))
        pts = np.concatenate([blob, chain, rng.uniform(-30, 30, (60, 3))])
        mask = np.ones(len(pts), bool)
        mask[-10:] = False
        tol = 0.025
    else:
        centres = rng.uniform(-5, 5, (6, 3))
        pts = np.concatenate([rng.normal(c, 0.2, (k, 3)) for c, k in
                              zip(centres, (90, 150, 150, 60, 30, 20))])
        mask = rng.random(len(pts)) > 0.05
        tol = 0.3
    pts = pts.astype(np.float32)
    m_r, l_r = r_ransac.euclidean_cluster_mask(jnp.asarray(pts), jnp.asarray(mask),
                                               tol, chunk=128)
    m_p, l_p = ransac.euclidean_cluster_mask(torch.from_numpy(pts),
                                             torch.from_numpy(mask), tol, chunk=128)
    np.testing.assert_array_equal(np_(l_p), np.asarray(l_r))   # exact labels
    np.testing.assert_array_equal(np_(m_p), np.asarray(m_r))
    if case == "chain_2cm":
        assert np_(m_p)[200:500].all() and not np_(m_p)[:200].any()
