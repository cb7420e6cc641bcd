"""Parity of the PyTorch port's ops with the JAX package, on the CPU.

The same float32 inputs, made with numpy from a seed, go through the JAX
function and its port; tolerances are stated at each assertion. The CUDA
kernel itself is checked against its plain version on the card in
tests/test_torch_kernels.py.
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from delta_graph_slam_tpu import ops as R
from delta_graph_slam_tpu.ops.pallas_nn import nn_1_pallas
from delta_graph_slam_tpu_torch.io.kitti import make_city_world
from delta_graph_slam_tpu_torch.io.lidar_sim import raycast_scan
from delta_graph_slam_tpu_torch.ops import cloud as P
from delta_graph_slam_tpu_torch.ops import knn as P_knn
from delta_graph_slam_tpu_torch.ops import normals as P_normals
from delta_graph_slam_tpu_torch.ops import outliers as P_outliers
from delta_graph_slam_tpu_torch.ops import segment as P_segment
from delta_graph_slam_tpu_torch.ops import voxel as P_voxel
from delta_graph_slam_tpu_torch.ops import voxel_knn as P_vknn
from delta_graph_slam_tpu_torch.register import covariance as P_cov

from test_torch_kernels import nn_case as _nn_case  # noqa: E402

torch.set_num_threads(2)

# the reference packages export functions under their module names
R_knn = importlib.import_module("delta_graph_slam_tpu.ops.knn")
R_cov = importlib.import_module("delta_graph_slam_tpu.register.covariance")

OFFS7 = np.asarray([[0, 0, 0], [1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                    [0, 0, 1], [0, 0, -1]], np.int32)
OFFS27 = np.asarray([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                     for k in (-1, 0, 1)], np.int32)


def np_(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def both_clouds(pts, mask=None, capacity=None):
    pts = np.asarray(pts, np.float32)
    return (R.make_cloud(pts, mask, capacity=capacity),
            P.make_cloud(pts, mask, capacity=capacity))


@pytest.fixture(scope="module")
def scan():
    """One raycast street scan (about 55k returns), float32."""
    return raycast_scan(make_city_world(seed=0), np.array([-50.0, 0.0, 0.0]),
                        seed=1000)


@pytest.fixture(scope="module")
def downsampled(scan):
    """The scan at 0.1 m (4096 voxels kept), as the prefilter hands it on."""
    _, pc = both_clouds(scan[:16384], capacity=16384)
    out = P.compact(P_voxel.voxel_downsample(pc, 0.1, capacity_out=4096))
    return np_(out.points), np_(out.mask)


def _pallas(q, qm, t, tm):
    """nn_1_pallas in interpret mode, on inputs padded with invalid rows to
    whole tiles (the kernel asserts divisibility)."""
    n, m = len(q), len(t)
    tq, tt = 512, 1024
    pn, pm = -(-n // tq) * tq, -(-m // tt) * tt
    qp = np.zeros((pn, 3), np.float32)
    qp[:n] = q
    tp = np.zeros((pm, 3), np.float32)
    tp[:m] = t
    d2, idx = nn_1_pallas(jnp.asarray(qp), jnp.asarray(np.pad(qm, (0, pn - n))),
                          jnp.asarray(tp), jnp.asarray(np.pad(tm, (0, pm - m))),
                          tile_q=tq, tile_t=tt, interpret=True)
    d2 = np.asarray(d2)[:n]
    # the Pallas kernel's "no target" sentinel is the finite 3.4e38
    return np.where(d2 >= 3.4e38, np.inf, d2), np.asarray(idx)[:n]


@pytest.mark.parametrize("case", ["tiles", "ragged", "all_invalid_targets",
                                  "exclude_self", "single_query", "ties"])
def test_nn_1_matches_reference(case):
    q, qm, t, tm = _nn_case(case)
    excl = case == "exclude_self"
    d2_p, i_p = P_knn.nn_1(torch.from_numpy(q), torch.from_numpy(qm),
                           torch.from_numpy(t), torch.from_numpy(tm),
                           exclude_self=excl, chunk=256)
    d2_p, i_p = np_(d2_p), np_(i_p)
    refs = [R_knn.nn_1(jnp.asarray(q), jnp.asarray(qm), jnp.asarray(t),
                       jnp.asarray(tm), exclude_self=excl, chunk=256)]
    if not excl:  # the Pallas kernel has no exclude_self
        refs.append(_pallas(q, qm, t, tm))
    for d2_r, i_r in refs:
        d2_r, i_r = np.asarray(d2_r), np.asarray(i_r)
        # inf exactly where the reference has inf (invalid query / no target)
        np.testing.assert_array_equal(np.isinf(d2_p), np.isinf(d2_r))
        fin = np.isfinite(d2_r)
        # d2 atol 1e-3: float32 |q|^2 - 2q.t + |t|^2 summed in another order
        np.testing.assert_allclose(d2_p[fin], d2_r[fin], atol=1e-3)
        if fin.any():
            # index agreement > 99% on valid queries (near-ties may differ)
            assert (i_p[fin] == i_r[fin]).mean() > 0.99
        if case == "ties":  # exact distances: the first of the equal copies
            np.testing.assert_array_equal(i_p, i_r)


def _segment_case(kind):
    """(vals, sorted ids with dump slot n, n) of one segment-sum case."""
    rng = np.random.default_rng(3)
    if kind == "voxel_runs":      # runs of 1-40 points, a long dump run
        runs = rng.integers(1, 40, 700)
        ids = np.repeat(np.arange(len(runs)), runs)
        n = 600                   # runs beyond n overflow into the dump
        ids = np.concatenate([np.minimum(ids, n), np.full(5000, n)])
        vals = rng.normal(0, 30, (len(ids), 13))
    elif kind == "empty_cells":   # every other cell empty, 1-D values
        ids = np.sort(rng.choice(np.arange(0, 2000, 2), 5000))
        n = 2001
        vals = rng.normal(0, 30, len(ids))
    else:                         # nothing valid: everything in the dump
        n = 64
        ids = np.full(300, n)
        vals = rng.normal(0, 30, (300, 3))
    return torch.from_numpy(vals.astype(np.float32)), torch.from_numpy(ids), n


@pytest.mark.parametrize("kind", ["voxel_runs", "empty_cells", "all_dump"])
def test_sorted_segment_sum_equals_index_add_bitwise(kind):
    """The run-wise sum of ops/segment.py adds each run in order: on the CPU
    its bits are those of index_add_ into n + 1 slots, the dump dropped."""
    vals, ids, n = _segment_case(kind)
    want = torch.zeros((n + 1,) + vals.shape[1:]).index_add_(0, ids, vals)[:-1]
    got = P_segment.segment_sum(vals, ids, n, sorted_ids=True)
    assert got.shape == want.shape and torch.equal(got, want)


def test_unsorted_segment_sum_equals_index_add_bitwise():
    """The sort-based sum of the graph solve, on shuffled ids and under
    deterministic() as the solve calls it: the same bits as index_add_ on
    the CPU, and the switch restored when the block ends."""
    vals, ids, n = _segment_case("voxel_runs")
    keep = ids < n
    vals, ids = vals[keep], ids[keep]
    perm = torch.from_numpy(np.random.default_rng(4).permutation(len(ids)))
    vals, ids = vals[perm], ids[perm]
    before = torch.are_deterministic_algorithms_enabled()
    with P_segment.deterministic():
        assert torch.are_deterministic_algorithms_enabled()
        got = P_segment.segment_sum(vals, ids, n)
    assert torch.are_deterministic_algorithms_enabled() == before
    want = torch.zeros((n,) + vals.shape[1:]).index_add_(0, ids, vals)
    assert torch.equal(got, want)


def test_knn_radius_count_match_reference():
    rng = np.random.default_rng(1)
    pts = rng.uniform(-3, 3, (700, 3)).astype(np.float32)
    pts[600:] = pts[:100]                       # exact duplicates: tie order
    mask = rng.random(700) > 0.1
    rc, pc = both_clouds(pts, mask)
    d_r, i_r = R_knn.knn(rc.points, rc.mask, rc.points, rc.mask, 8,
                         exclude_self=True, chunk=256)
    d_p, i_p = P_knn.knn(pc.points, pc.mask, pc.points, pc.mask, 8,
                         exclude_self=True, chunk=256)
    d_r, d_p = np.asarray(d_r), np_(d_p)
    # d2 atol 1e-4 (float32 expansion at |p| <= 5); the same neighbours in
    # the same order, duplicates included (lower index first on ties)
    np.testing.assert_allclose(d_p, d_r, atol=1e-4)
    v = mask
    assert (np_(i_p)[v] == np.asarray(i_r)[v]).mean() > 0.99
    c_r = R_knn.radius_count(rc.points, rc.mask, 0.7, chunk=256)
    c_p = P_knn.radius_count(pc.points, pc.mask, 0.7, chunk=256)
    np.testing.assert_array_equal(np_(c_p), np.asarray(c_r))  # counts: exact


@pytest.mark.parametrize("mask_kind", ["all", "some", "none"])
def test_masked_cloud_count_matches_reference(scan, mask_kind):
    mask = {"all": np.ones(4000, bool), "none": np.zeros(4000, bool),
            "some": np.random.default_rng(5).random(4000) < 0.3}[mask_kind]
    rc, pc = both_clouds(scan[:4000], mask, capacity=4500)
    assert pc.capacity == rc.capacity == 4500
    assert int(pc.count()) == int(rc.count()) == int(mask.sum())


def test_cloud_filters_match_reference(scan):
    rc, pc = both_clouds(scan[:5000], capacity=6000)
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.5, -0.2, 0.1]
    for fr, fp in [
        (lambda c: R.distance_filter(c, 2.0, 30.0),
         lambda c: P.distance_filter(c, 2.0, 30.0)),
        (lambda c: R.flatten_z(R.height_filter(c, -1.0)),
         lambda c: P.flatten_z(P.height_filter(c, -1.0))),
        (lambda c: R.compact(R.distance_filter(c, 5.0, 20.0)),
         lambda c: P.compact(P.distance_filter(c, 5.0, 20.0))),
        (lambda c: R.transform_cloud(c, T), lambda c: P.transform_cloud(c, T)),
    ]:
        r, p = fr(rc), fp(pc)
        np.testing.assert_array_equal(np_(p.mask), np.asarray(r.mask))
        # translation only: exact up to float32 rounding of one add
        np.testing.assert_allclose(np_(p.points), np.asarray(r.points), atol=1e-6)


def test_voxel_downsample_matches_reference_under_overflow(scan):
    """A 0.1 m grid over 16k returns occupies far more than 4096 voxels: the
    same cells must be kept, slot by slot (DIVERGENCES.md §9)."""
    rc, pc = both_clouds(scan[:16384], capacity=16384)
    # jitted with the resolution as a constant, as the prefilter runs it
    r = jax.jit(lambda c: R.voxel_downsample(c, 0.1, capacity_out=4096))(rc)
    p = P_voxel.voxel_downsample(pc, 0.1, capacity_out=4096)
    np.testing.assert_array_equal(np_(p.mask), np.asarray(r.mask))
    assert np_(p.mask).all()                    # overflowed: every slot used
    # centroids: atol 1e-5 m, the summation order of the cell sums may differ
    np.testing.assert_allclose(np_(p.points), np.asarray(r.points), atol=1e-5)


@pytest.mark.parametrize("dense", [True, False])
def test_voxel_hash_and_lookup_match_reference(downsampled, dense):
    pts, mask = downsampled
    rc, pc = both_clouds(pts, mask)
    # 1 m cells over 4096 points occupy more than 512 voxels: overflow again
    rh = jax.jit(lambda c: R.build_voxel_hash(
        c, 1.0, 512, dense_index=dense, with_stats=True))(rc)
    ph = P_voxel.build_voxel_hash(pc, 1.0, 512, dense_index=dense,
                                  with_stats=True)
    for field in ("keys", "starts", "counts", "sorted_points", "sorted_valid",
                  "origin"):
        np.testing.assert_array_equal(np_(getattr(ph, field)),
                                      np.asarray(getattr(rh, field)), field)
    if dense:
        np.testing.assert_array_equal(np_(ph.dense_slot), np.asarray(rh.dense_slot))
    # cell means: atol 1e-4 m, float32 sums in another order; covariances
    # E[xx^T] - mean mean^T cancel at |x|^2 ~ 1e3 m^2, so atol 1e-3 m^2
    np.testing.assert_allclose(np_(ph.means), np.asarray(rh.means), atol=1e-4)
    np.testing.assert_allclose(np_(ph.covs), np.asarray(rh.covs), atol=1e-3)
    q = pts + np.float32(0.3)
    for offs in (OFFS7, OFFS27):
        s_r, h_r = jax.jit(lambda v, x, m: R.voxel_lookup(v, x, m, offs))(
            rh, jnp.asarray(q), jnp.asarray(mask))
        s_p, h_p = P_voxel.voxel_lookup(ph, torch.from_numpy(q),
                                        torch.from_numpy(mask), offs)
        np.testing.assert_array_equal(np_(h_p), np.asarray(h_r))
        hit = np.asarray(h_r)
        np.testing.assert_array_equal(np_(s_p)[hit], np.asarray(s_r)[hit])


def _dup_cloud():
    """Points on a few planes plus exact duplicates (tie order)."""
    rng = np.random.default_rng(3)
    a = rng.uniform(-4, 4, (900, 3)).astype(np.float32)
    a[:300, 2] = 0.0
    a[300:600, 0] = 1.5
    dup = a[rng.choice(900, 150, replace=False)]
    pts = np.concatenate([a, dup, np.zeros((74, 3), np.float32)])
    mask = np.arange(len(pts)) < 1050
    return pts, mask


def _well_conditioned(nb, valid, gap=0.05):
    """Neighbourhoods whose smallest eigenvector is well defined: the gap
    between the two smallest eigenvalues of their float64 covariance is at
    least ``gap`` of the largest. Elsewhere (near-collinear ring returns,
    duplicates) float32 rounding alone can turn that eigenvector."""
    w = np.asarray(valid, np.float64)[..., None]
    nb = np.asarray(nb, np.float64)
    cnt = np.maximum(w.sum(1), 1.0)
    c = (nb - (nb * w).sum(1, keepdims=True) / cnt[:, None]) * w
    ev = np.linalg.eigvalsh(np.einsum("nka,nkb->nab", c, c) / cnt[:, :, None])
    return (ev[:, 1] - ev[:, 0]) > gap * np.maximum(ev[:, 2], 1e-12)


def _hashes(pts, mask):
    rc, pc = both_clouds(pts, mask)
    rh = jax.jit(lambda c: R.build_voxel_hash(c, 1.0, 1024, dense_index=True,
                                              with_stats=False))(rc)
    ph = P_voxel.build_voxel_hash(pc, 1.0, 1024, dense_index=True,
                                  with_stats=False)
    return rh, ph


@pytest.mark.parametrize("k,window,offs", [(1, 8, OFFS7), (5, 8, OFFS7),
                                           (20, 8, OFFS7), (10, 16, OFFS27)])
def test_voxel_knn_matches_reference(k, window, offs):
    pts, mask = _dup_cloud()
    rh, ph = _hashes(pts, mask)
    q = pts + np.float32(0.05)
    d_r, i_r, v_r = jax.jit(lambda v, x, m: R.voxel_knn(v, x, m, k, offs, window))(
        rh, jnp.asarray(q), jnp.asarray(mask))
    d_p, i_p, v_p = P_vknn.voxel_knn(ph, torch.from_numpy(q),
                                     torch.from_numpy(mask), k, offs, window)
    np.testing.assert_array_equal(np_(v_p), np.asarray(v_r))
    v = np.asarray(v_r)
    # d2 atol 1e-6: both sum the same three float32 squares
    np.testing.assert_allclose(np_(d_p)[v], np.asarray(d_r)[v], atol=1e-6)
    # duplicates tie exactly: the earlier candidate must win on both sides
    np.testing.assert_array_equal(np_(i_p)[v], np.asarray(i_r)[v])


@pytest.mark.parametrize("k,window,offs", [(20, 8, OFFS7), (10, 16, OFFS27)])
def test_voxel_knn_covariances_match_reference(k, window, offs):
    pts, mask = _dup_cloud()
    rh, ph = _hashes(pts, mask)
    cov_r, ok_r = jax.jit(lambda v: R.voxel_knn_covariances(
        v, k=k, offsets=offs, window=window))(rh)
    cov_p, ok_p = P_vknn.voxel_knn_covariances(ph, k=k, offsets=offs,
                                               window=window)
    np.testing.assert_array_equal(np_(ok_p), np.asarray(ok_r))
    _, idx, valid = P_vknn.voxel_knn(ph, ph.sorted_points, ph.sorted_valid, k,
                                     offs, window)
    good = np.asarray(ok_r) & _well_conditioned(np_(ph.sorted_points)[np_(idx)],
                                                np_(valid))
    assert good.sum() > 0.9 * np.asarray(ok_r).sum()
    # plane-regularized covariances (unit eigenvalues): atol 1e-3 where the
    # normal direction is well defined (closed-form float32 eigenvectors;
    # det by cofactors here, by LU in the reference)
    np.testing.assert_allclose(np_(cov_p)[good], np.asarray(cov_r)[good],
                               atol=1e-3)


def test_covariance_models_match_reference():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(500, 3, 3)).astype(np.float32)
    A = A @ A.transpose(0, 2, 1) + 1e-3 * np.eye(3, dtype=np.float32)
    A[:10] = np.eye(3, dtype=np.float32)        # isotropic: fallback vectors
    vals_r, _ = R_cov.eigh3x3(jnp.asarray(A))
    vals_p, _ = P_cov.eigh3x3(torch.from_numpy(A))
    # eigenvalues of entries of order 1-10: rtol/atol 1e-4 (float32 closed form)
    np.testing.assert_allclose(np_(vals_p), np.asarray(vals_r), rtol=1e-4, atol=1e-4)
    ev = np.linalg.eigvalsh(A.astype(np.float64))
    good = np.diff(ev, axis=1).min(1) > 0.05 * ev[:, 2]
    good[:10] = True
    for mode in ("plane", "floor"):
        r = np.asarray(R_cov.regularize_covariances(jnp.asarray(A), mode=mode))
        p = np_(P_cov.regularize_covariances(torch.from_numpy(A), mode=mode))
        # atol 1e-3 (rtol 1e-3 for 'floor', which keeps eigenvalues up to
        # ~30) where all eigenvalues are apart
        np.testing.assert_allclose(p[good], r[good], atol=1e-3, rtol=1e-3)
    pts, mask = _dup_cloud()
    c_r, v_r = R_cov.knn_covariances(jnp.asarray(pts), jnp.asarray(mask), k=20,
                                     chunk=256)
    c_p, v_p = P_cov.knn_covariances(torch.from_numpy(pts),
                                     torch.from_numpy(mask), k=20, chunk=256)
    np.testing.assert_array_equal(np_(v_p), np.asarray(v_r))
    _, idx = P_knn.knn(torch.from_numpy(pts), torch.from_numpy(mask),
                       torch.from_numpy(pts), torch.from_numpy(mask), 20, chunk=256)
    good = np.asarray(v_r) & _well_conditioned(pts[np_(idx)], np.ones(idx.shape))
    assert good.sum() > 0.9 * np.asarray(v_r).sum()
    np.testing.assert_allclose(np_(c_p)[good], np.asarray(c_r)[good], atol=1e-3)


@pytest.mark.parametrize("method", ["voxel", "brute"])
def test_outliers_and_normals_match_reference(downsampled, method):
    pts, mask = downsampled
    rc, pc = both_clouds(pts, mask)
    r = jax.jit(lambda c: R.radius_outlier_removal(c, 0.5, 2, chunk=1024,
                                                   method=method))(rc)
    p = P_outliers.radius_outlier_removal(pc, 0.5, 2, chunk=1024, method=method)
    np.testing.assert_array_equal(np_(p.mask), np.asarray(r.mask))  # exact
    n_r, v_r = jax.jit(lambda c: R.estimate_normals(c, 10, chunk=1024,
                                                    method=method))(rc)
    n_p, v_p = P_normals.estimate_normals(pc, 10, chunk=1024, method=method)
    np.testing.assert_array_equal(np_(v_p), np.asarray(v_r))
    _, idx = P_knn.knn(pc.points, pc.mask, pc.points, pc.mask, 10, chunk=1024)
    good = np.asarray(v_r) & _well_conditioned(pts[np_(idx)], np.ones(idx.shape))
    # same normal axis (|cos| within 1e-4 of 1) where the neighbourhood is
    # not near-collinear; > 99%: the 10th neighbour may differ on near-ties
    same_axis = np.abs(np.abs((np_(n_p) * np.asarray(n_r)).sum(1)) - 1) < 1e-4
    assert same_axis[good].mean() > 0.99, same_axis[good].mean()
    f_r = jax.jit(lambda c: R.normal_filter(c, 0.2, 10, chunk=1024,
                                            method=method))(rc)
    f_p = P_normals.normal_filter(pc, 0.2, 10, chunk=1024, method=method)
    # the wall test |n_z| < 0.2 flips for at most 0.5% of the points
    assert (np_(f_p.mask) != np.asarray(f_r.mask)).mean() <= 0.005


def test_statistical_outlier_removal_matches_reference(downsampled):
    pts, mask = downsampled
    rc, pc = both_clouds(pts[:2048], mask[:2048])
    r = jax.jit(lambda c: R.statistical_outlier_removal(c, 20, 1.0, chunk=512))(rc)
    p = P_outliers.statistical_outlier_removal(pc, 20, 1.0, chunk=512)
    # a point flips only if its mean distance sits within float32 rounding
    # of the global threshold
    assert (np_(p.mask) != np.asarray(r.mask)).sum() <= 1
