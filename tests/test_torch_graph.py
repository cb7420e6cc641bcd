"""The port's pose graph (delta_graph_slam_tpu_torch.graph) against the JAX
package's on the same numpy inputs.

Reference graphs come from tests/test_graph.py. Both packages solve them
packed at one table size (24 vertices, 24 edges a table), so the JAX
package compiles one program per backend; padding changes no solve, as
test_padded_tables_give_the_same_solve checks. conftest.py turns x64 on,
so the JAX package runs its double-float state in float64 limbs and the
two packages agree to roundoff.
"""

import dataclasses
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delta_graph_slam_tpu.geom import se2 as r_se2
from delta_graph_slam_tpu.graph import SE2GraphBuilder as RBuilder
from delta_graph_slam_tpu.graph import SolverConfig as RConfig
from delta_graph_slam_tpu.graph import load_g2o as r_load_g2o
from delta_graph_slam_tpu.graph import optimize_se2 as r_optimize
from delta_graph_slam_tpu.graph import robust_rho as r_rho
from delta_graph_slam_tpu.graph import robust_weight as r_weight
from delta_graph_slam_tpu.graph import save_g2o as r_save_g2o
from delta_graph_slam_tpu.graph import se2_graph as r_se2g
from delta_graph_slam_tpu_torch.geom import se2 as p_se2
from delta_graph_slam_tpu_torch.graph import (
    ROBUST_KERNELS, SE2GraphBuilder, SolverConfig, load_g2o, load_npz,
    optimize_se2, robust_rho, robust_weight, save_g2o, save_npz,
)
from delta_graph_slam_tpu_torch.graph.chain_solve import (
    bcr_apply, bcr_factor, chain_solve, offchain_overflow,
)
from delta_graph_slam_tpu_torch.graph import se2_graph as p_se2g
from delta_graph_slam_tpu_torch.graph.lm_core import gradient
from delta_graph_slam_tpu_torch.graph.solver import _free_mask, _linearize
from delta_graph_slam_tpu_torch.interop import builder_from_reference

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the numpy bench graph and the host f64 LM)

torch.set_num_threads(2)
CAP = 24        # vertex and per-table edge capacity of the shared packing
INFO = np.diag([100.0, 100.0, 400.0])


def relpose(a, b):
    return np.asarray(r_se2.se2_compose(r_se2.se2_inverse(jnp.asarray(a)),
                                        jnp.asarray(b)))


# --------------------------------------------------------------- geometry

def test_se2_ops_match_reference():
    rng = np.random.default_rng(0)
    a = rng.normal(size=(64, 3)) * [5.0, 5.0, 4.0]
    b = rng.normal(size=(64, 3)) * [5.0, 5.0, 4.0]
    b[:8, 2] = rng.normal(size=8) * 1e-8          # the Taylor branches
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    ja, jb = jnp.asarray(a), jnp.asarray(b)
    pairs = [
        (p_se2.normalize_angle(ta[:, 2]), r_se2.normalize_angle(ja[:, 2])),
        (p_se2.se2_compose(ta, tb), r_se2.se2_compose(ja, jb)),
        (p_se2.se2_inverse(ta), r_se2.se2_inverse(ja)),
        (p_se2.se2_exp(tb), r_se2.se2_exp(jb)),
        (p_se2.se2_log(tb), r_se2.se2_log(jb)),
    ]
    meas = b * [0.3, 0.3, 0.5]
    pairs += [
        (p_se2g.se2_edge_error(ta, tb, torch.from_numpy(meas)),
         jax.vmap(r_se2g.se2_edge_error)(ja, jb, jnp.asarray(meas))),
        (p_se2g.se2_prior_xy_error(ta, tb[:, :2]),
         jax.vmap(r_se2g.se2_prior_xy_error)(ja, jb[:, :2])),
        (p_se2g.se2_prior_yaw_error(ta, tb[:, 2]),
         jax.vmap(r_se2g.se2_prior_yaw_error)(ja, jb[:, 2])),
    ]
    for got, want in pairs:
        # float64 elementwise math on both sides: equal to roundoff
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12)


def test_se2_matrix_ops_match_reference():
    """rot2, se2_matrix, se2_params and se2_apply as tensor functions."""
    rng = np.random.default_rng(4)
    p = rng.normal(size=(32, 3)) * [5.0, 5.0, 4.0]
    pts = rng.normal(size=(32, 9, 2)) * 10.0
    tp, jp = torch.from_numpy(p), jnp.asarray(p)
    M = p_se2.se2_matrix(tp)
    pairs = [
        (p_se2.rot2(tp[:, 2]), r_se2.rot2(jp[:, 2])),
        (M, r_se2.se2_matrix(jp)),
        (p_se2.se2_params(M), r_se2.se2_params(jnp.asarray(M.numpy()))),
        (p_se2.se2_apply(tp, torch.from_numpy(pts)), r_se2.se2_apply(jp, jnp.asarray(pts))),
    ]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)
    # params -> matrix -> params is the identity up to the angle's wrap
    np.testing.assert_allclose(p_se2.se2_params(M).numpy()[:, :2], p[:, :2], atol=1e-12)


def test_builder_counts_and_set_all_fixed_match_reference():
    """num_vertices, num_edges and set_all_fixed (se2_graph.py:128-142)."""
    builders = (SE2GraphBuilder(device="cpu"), RBuilder())
    for b in builders:
        for k in range(5):
            b.add_vertex([float(k), 0.0, 0.0], fixed=(k == 0))
        for k in range(4):
            b.add_se2_edge(k, k + 1, [1.0, 0.0, 0.0], INFO)
        b.add_prior_xy(2, [2.0, 0.1], np.eye(2))
        b.set_all_fixed(True, only=[1, 3])
    assert [b.fixed for b in builders] == [[True, True, False, True, False]] * 2
    assert [(b.num_vertices, b.num_edges) for b in builders] == [(5, 5)] * 2
    for b in builders:
        b.set_all_fixed(False)
    assert builders[0].fixed == builders[1].fixed == [False] * 5
    # a flag change repacks the vertex table
    g = builders[0].to_arrays(v_capacity=8, e_capacity=8)
    builders[0].set_all_fixed(True)
    assert builders[0].to_arrays(v_capacity=8, e_capacity=8).fixed[:5].all()
    assert not g.fixed[:5].any()


@pytest.mark.parametrize("name", ROBUST_KERNELS)
def test_robust_kernel_matches_reference(name):
    k = ROBUST_KERNELS.index(name)
    e2 = np.concatenate([np.linspace(0.0, 6.0, 25), [0.3, 40.0, 1e4]])
    delta = np.concatenate([np.full(25, 1.3), [0.0, -1.0, 2.5]])  # <= 0: width 1
    ids = np.full(e2.shape, k)
    got_rho = robust_rho(torch.from_numpy(e2), torch.from_numpy(ids),
                         torch.from_numpy(delta))
    got_w = robust_weight(torch.from_numpy(e2), torch.from_numpy(ids),
                          torch.from_numpy(delta))
    want_rho = r_rho(jnp.asarray(e2), jnp.asarray(ids), jnp.asarray(delta))
    want_w = r_weight(jnp.asarray(e2), jnp.asarray(ids), jnp.asarray(delta))
    # the same float64 formulas: equal to roundoff
    np.testing.assert_allclose(got_rho.numpy(), np.asarray(want_rho), rtol=1e-12)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-12)


# ------------------------------------------------ the reference test graphs

def _ring(n=20, noise=0.05, seed=5):
    """tests/test_graph.py:64-82: noisy circle + closing edge."""
    rng = np.random.default_rng(seed)
    ang = 2 * np.pi * np.arange(n) / n
    gt = np.stack([np.cos(ang) * 5, np.sin(ang) * 5, ang + np.pi / 2], 1)
    b = RBuilder()
    for k in range(n):
        b.add_vertex(gt[k] + rng.normal(0, noise, 3) * (k > 0), fixed=(k == 0))
    for k in range(n - 1):
        b.add_se2_edge(k, k + 1, relpose(gt[k], gt[k + 1]), INFO)
    b.add_se2_edge(n - 1, 0, relpose(gt[-1], gt[0]), INFO)
    return b


def _priors():
    b = RBuilder()
    b.add_vertex([0.0, 0.0, 0.0])
    b.add_vertex([1.0, 0.0, 0.0])
    for _ in range(5):
        b.add_se2_edge(0, 1, [1.0, 0.0, 0.0], np.eye(3))
    b.add_prior_xy(0, [2.0, 3.0], np.eye(2) * 1000)
    for _ in range(4):
        b.add_prior_yaw(1, 0.5, 1000.0)
    return b


def _level_masking():
    b = RBuilder()
    b.add_vertex([0.0, 0.0, 0.0], fixed=True)
    b.add_vertex([1.0, 0.0, 0.0])
    b.add_vertex([5.0, 5.0, 0.0])
    for _ in range(10):
        b.add_se2_edge(0, 1, [2.0, 0.0, 0.0], np.eye(3) * 100, level=0)
    b.add_se2_edge(0, 2, [0.0, 1.0, 0.0], np.eye(3) * 100, level=1)
    return b


def _fixed_vertices():
    b = RBuilder()
    b.add_vertex([1.0, 1.0, 0.3], fixed=True)
    b.add_vertex([0.0, 0.0, 0.0])
    for _ in range(10):
        b.add_se2_edge(0, 1, [1.0, 0.0, 0.0], np.eye(3))
    return b


def _huber_outlier():
    b = _ring(noise=0.02)
    b.add_se2_edge(3, 12, [20.0, 20.0, 1.0], np.eye(3) * 100, kernel="Huber",
                   delta=1.0)
    return b


def _min_edges():
    b = RBuilder()
    b.add_vertex([0.0, 0.0, 0.0])
    b.add_vertex([3.0, 0.0, 0.0])
    b.add_se2_edge(0, 1, [1.0, 0.0, 0.0], np.eye(3))
    return b


GRAPHS = {"ring": _ring, "priors": _priors, "level_masking": _level_masking,
          "fixed_vertices": _fixed_vertices, "huber_outlier": _huber_outlier,
          "min_edges_skip": _min_edges}
BACKENDS = {
    "dense": dict(backend="dense", max_iterations=50),
    "cg": dict(backend="cg", max_iterations=50, cg_max_iters=200),
    "chain": dict(backend="chain", max_iterations=50),
}


def _assert_same_solve(got, want, label):
    """DIVERGENCES §13's contract, tightened for float64 on both sides:
    with the same LM iteration count, poses within 1e-6 and chi2 within
    1e-9 relative; otherwise the same final chi2 within 1e-6 relative."""
    (pp, sp), (pr, sr) = got, want
    chi2_p, chi2_r = float(sp.chi2_final), float(sr.chi2_final)
    if sp.iterations == int(sr.iterations):
        np.testing.assert_allclose(pp.numpy(), np.asarray(pr), rtol=0, atol=1e-6,
                                   err_msg=label)
        assert abs(chi2_p - chi2_r) <= 1e-9 * abs(chi2_r) + 1e-15, (label, chi2_p, chi2_r)
    else:
        assert abs(chi2_p - chi2_r) <= 1e-6 * abs(chi2_r) + 1e-12, (label, chi2_p, chi2_r)


@pytest.mark.parametrize("backend", list(BACKENDS))
@pytest.mark.parametrize("graph", list(GRAPHS))
def test_optimize_se2_matches_reference(graph, backend):
    rb = GRAPHS[graph]()
    pb = builder_from_reference(rb)
    want = r_optimize(rb.to_arrays(v_capacity=CAP, e_capacity=CAP), level=0,
                      config=RConfig(**BACKENDS[backend]))
    got = optimize_se2(pb.to_arrays(v_capacity=CAP, e_capacity=CAP), level=0,
                       config=SolverConfig(**BACKENDS[backend]))
    _assert_same_solve(got, want, f"{graph}/{backend}")
    if graph == "min_edges_skip":
        assert got[1].iterations == -1
        np.testing.assert_array_equal(got[0].numpy()[:2, 0], [0.0, 3.0])
    if graph == "level_masking":        # the level-1 vertex is untouched
        np.testing.assert_array_equal(got[0].numpy()[2], [5.0, 5.0, 0.0])


def test_level1_solve_matches_reference():
    rb = _level_masking()
    for _ in range(9):                  # pass the whole-graph min_edges gate
        rb.add_se2_edge(0, 2, [0.0, 1.0, 0.0], np.eye(3) * 100, level=1)
    pb = builder_from_reference(rb)
    cfg = BACKENDS["dense"]
    want = r_optimize(rb.to_arrays(v_capacity=CAP, e_capacity=CAP), level=1,
                      config=RConfig(**cfg))
    got = optimize_se2(pb.to_arrays(v_capacity=CAP, e_capacity=CAP), level=1,
                       config=SolverConfig(**cfg))
    _assert_same_solve(got, want, "level 1")
    np.testing.assert_allclose(got[0].numpy()[2], [0.0, 1.0, 0.0], atol=1e-6)


# ------------------------------------------------------------- chain solve

def test_bcr_matches_dense_tridiagonal_solve():
    rng = np.random.default_rng(3)
    M, D, R = 64, 3, 2
    A = np.zeros((M, D, D))
    for k in range(M):
        Q = rng.normal(size=(D, D))
        A[k] = Q @ Q.T + 5 * np.eye(D)
    B = np.zeros((M, D, D))
    B[1:] = 0.5 * rng.normal(size=(M - 1, D, D))
    g = rng.normal(size=(M, D, R))
    T = np.zeros((M * D, M * D))
    for k in range(M):
        T[k * D:(k + 1) * D, k * D:(k + 1) * D] = A[k]
    for k in range(1, M):
        T[k * D:(k + 1) * D, (k - 1) * D:k * D] = B[k]
        T[(k - 1) * D:k * D, k * D:(k + 1) * D] = B[k].T
    want = np.linalg.solve(T, g.reshape(M * D, R))
    for base in (1, 8):
        got = bcr_apply(bcr_factor(torch.from_numpy(A), torch.from_numpy(B),
                                   base_blocks=base), torch.from_numpy(g))
        # float64 elimination of a well-conditioned system: 1e-12 relative
        np.testing.assert_allclose(got.numpy().reshape(M * D, R), want, rtol=0,
                                   atol=1e-12 * np.abs(want).max())
    got32 = bcr_apply(bcr_factor(torch.from_numpy(A).float(),
                                 torch.from_numpy(B).float(), base_blocks=8),
                      torch.from_numpy(g).float())
    # float32 path: the JAX package's bound (test_graph.py:336)
    np.testing.assert_allclose(got32.numpy().reshape(M * D, R), want, rtol=0,
                               atol=2e-4 * np.abs(want).max())


def _lap_graph(n=96):
    """tests/test_graph.py:338-363: two laps, loops every 20 nodes."""
    rng = np.random.default_rng(11)
    b = RBuilder()
    lap = n // 2
    gt = np.zeros((n, 3))
    for k in range(1, n):
        c, s = np.cos(gt[k - 1, 2]), np.sin(gt[k - 1, 2])
        gt[k] = [gt[k - 1, 0] + c, gt[k - 1, 1] + s, gt[k - 1, 2] + 2 * np.pi / lap]
    for k in range(n):
        b.add_vertex(gt[k] + (rng.normal(0, 0.05, 3) if k else 0), fixed=(k == 0))
    for k in range(n - 1):
        b.add_se2_edge(k, k + 1, relpose(gt[k], gt[k + 1]), INFO)
    for k in range(0, lap - 1, 20):
        b.add_se2_edge(k, k + lap, relpose(gt[k], gt[k + lap]), INFO,
                       kernel="Huber", delta=1.0)
    b.add_prior_xy(3, gt[3][:2], np.eye(2) * 10.0)
    return b


def test_offchain_overflow_count():
    pb = builder_from_reference(_lap_graph())
    g = pb.to_arrays()
    sysm, _ = _linearize(g, g.poses, 0)
    free = _free_mask(g, 0)
    N = g.poses.shape[0]
    b = gradient(sysm, N)
    # two free-free loops, (20,68) and (40,88); (0,48) hangs on the fixed
    # vertex 0 and folds into the chain
    assert pb.count_offchain(0) == 2
    _, nd = chain_solve(sysm, -b, free, torch.tensor(1e-4), N, K_cap=1,
                        base_blocks=8)
    assert int(nd) == 1
    assert int(offchain_overflow(sysm, free, 1)) == 1
    _, nd = chain_solve(sysm, -b, free, torch.tensor(1e-4), N, K_cap=2)
    assert int(nd) == 0


def _chain_first_graph(n=48):
    """tests/test_graph.py:509-536: alternating stored orientation of the
    odometry edges, loops, an xy and a yaw prior."""
    rng = np.random.default_rng(5)
    b = RBuilder()
    gt = np.zeros((n, 3))
    for k in range(1, n):
        c, s = np.cos(gt[k - 1, 2]), np.sin(gt[k - 1, 2])
        gt[k] = [gt[k - 1, 0] + c, gt[k - 1, 1] + s,
                 gt[k - 1, 2] + 2 * np.pi / (n // 2)]
    for k in range(n):
        b.add_vertex(gt[k] + (rng.normal(0, 0.05, 3) if k else 0), fixed=(k == 0))
    for k in range(n - 1):
        if k % 2:
            b.add_se2_edge(k, k + 1, relpose(gt[k], gt[k + 1]), INFO)
        else:
            b.add_se2_edge(k + 1, k, relpose(gt[k + 1], gt[k]), INFO)
    for k in range(0, n // 2 - 1, 12):
        b.add_se2_edge(k, k + n // 2, relpose(gt[k], gt[k + n // 2]), INFO,
                       kernel="Huber", delta=1.0)
    b.add_prior_xy(3, gt[3][:2], np.eye(2) * 10.0)
    b.add_prior_yaw(5, gt[5][2], 25.0)
    return b


def test_chain_first_tables_match_reference():
    rb = _chain_first_graph()
    pb = builder_from_reference(rb)
    want = rb.to_arrays(chain_first=True, e_capacity=8)
    got = pb.to_arrays(chain_first=True, e_capacity=8)
    for name in ("poses", "fixed", "vmask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))
    for table in ("edges", "priors_xy", "priors_yaw"):
        for field, val in getattr(want, table)._asdict().items():
            np.testing.assert_array_equal(
                getattr(getattr(got, table), field).numpy(), np.asarray(val),
                err_msg=f"{table}.{field}")


@pytest.mark.parametrize("precision", ["df", "f32"])
def test_chain_first_layout_matches_generic(precision):
    """The shift-based chain-first assembly (the fused chain_lm path for
    'df') solves like the generic scatter layout, reversed odometry edges
    included."""
    pb = builder_from_reference(_chain_first_graph())
    cfg = SolverConfig(backend="chain", max_iterations=30, chain_offrank_capacity=8,
                       chain_base_blocks=8, chain_precision=precision)
    p0, s0 = optimize_se2(pb.to_arrays(), level=0, config=cfg)
    g1 = pb.to_arrays(chain_first=True)
    p1, s1 = optimize_se2(g1, level=0, config=cfg, n_chain=g1.poses.shape[0] - 1)
    n = len(pb.poses)
    # float64: the two layouts differ by summation order only; float32
    # elimination (small graph, kappa ~ 1e4): the JAX package's bound
    tol = 1e-9 if precision == "df" else 1e-4
    assert abs(float(s1.chi2_final) - float(s0.chi2_final)) <= (
        tol * float(s0.chi2_final) + 1e-12)
    np.testing.assert_allclose(p1.numpy()[:n], p0.numpy()[:n],
                               atol=1e-7 if precision == "df" else 1e-4)


def test_fused_chain_lm_matches_reference():
    """The delta backend's path (chain-first, off_hint, n_chain) in both
    packages."""
    rb = _chain_first_graph()
    pb = builder_from_reference(rb)
    cfg = dict(backend="chain", max_iterations=30)
    gr = rb.to_arrays(chain_first=True)
    want = r_optimize(gr, level=0, config=RConfig(**cfg),
                      off_hint=rb.count_offchain(0), n_chain=gr.poses.shape[0] - 1)
    gp = pb.to_arrays(chain_first=True)
    got = optimize_se2(gp, level=0, config=SolverConfig(**cfg),
                       off_hint=pb.count_offchain(0), n_chain=gp.poses.shape[0] - 1)
    _assert_same_solve(got, want, "chain-first fused")


def test_padded_tables_give_the_same_solve():
    pb = builder_from_reference(_lap_graph())
    n = len(pb.poses)
    cfg = SolverConfig(backend="chain", max_iterations=40)
    out = []
    for vc, ec in ((None, None), (256, 512)):
        g = pb.to_arrays(v_capacity=vc, e_capacity=ec, chain_first=True)
        assert g.poses.shape[0] == (vc or 96)
        out.append(optimize_se2(g, level=0, config=cfg,
                                off_hint=pb.count_offchain(0),
                                n_chain=g.poses.shape[0] - 1))
    (p0, s0), (p1, s1) = out
    # padding vertices are vmask-false identity rows and padding edges
    # have W = 0: the same solve up to summation order (the graph's
    # measurements are exact, so chi2 ends at roundoff, ~1e-20)
    assert s0.iterations == s1.iterations
    assert abs(float(s1.chi2_final) - float(s0.chi2_final)) <= (
        1e-9 * float(s0.chi2_final) + 1e-15)
    np.testing.assert_allclose(p1.numpy()[:n], p0.numpy()[:n], rtol=0, atol=1e-9)
    np.testing.assert_array_equal(p1.numpy()[n:], 0.0)


def test_chain_reaches_host_f64_optimum():
    """The 512-node bench-shaped graph (tests/test_graph.py:366-439): the
    chain backend must land within 2% of a trusted float64 robust LM
    (scipy SuperLU, g2o schedule, 60 iterations)."""
    init, edges, _ = chip_smoke.bench_graph(512)
    b = chip_smoke.graph_builder(init, edges, "cpu")
    g = b.to_arrays(chain_first=True)
    _, stats = optimize_se2(g, level=0, config=SolverConfig(backend="chain",
                                                            max_iterations=60),
                            off_hint=b.count_offchain(0),
                            n_chain=g.poses.shape[0] - 1)
    _, _, chi2_host, _ = chip_smoke.host_lm(b, 60)
    assert float(stats.chi2_final) <= 1.02 * chi2_host + 1e-9, (
        float(stats.chi2_final), chi2_host)


# ---------------------------------------------------------------- builder

def test_to_arrays_reuses_unchanged_tables():
    b = SE2GraphBuilder(device="cpu")
    b.add_vertex([0, 0, 0], fixed=True)
    b.add_vertex([1, 0, 0])
    b.add_se2_edge(0, 1, [1, 0, 0], np.eye(3))
    b.add_prior_xy(1, [1, 0], np.eye(2))
    g1 = b.to_arrays()
    g2 = b.to_arrays()
    assert g2.edges.meas is g1.edges.meas and g2.poses is g1.poses
    b.set_pose(1, [2.0, 0.0, 0.0])
    g3 = b.to_arrays()
    assert g3.edges.meas is g1.edges.meas and g3.poses is not g1.poses
    eid = b.add_se2_edge(1, 0, [-1, 0, 0], np.eye(3))
    g4 = b.to_arrays()
    assert g4.priors_xy.meas is g1.priors_xy.meas
    assert int(g4.edges.mask.sum()) == 2
    b.remove_edge(eid)
    assert int(b.to_arrays().edges.mask.sum()) == 1


# --------------------------------------------------------------- file I/O

def test_g2o_round_trip_with_reference(tmp_path):
    """A .g2o (+ .kernels) written by the JAX package loads into the port
    and back, and solves the same."""
    rb = _huber_outlier()
    rb.add_prior_xy(4, [1.0, 2.0], np.eye(2) * 3.0, kernel="Cauchy", delta=2.0)
    rb.add_prior_yaw(6, 0.25, 7.0)
    r_save_g2o(rb, tmp_path / "ref.g2o")
    pb = load_g2o(tmp_path / "ref.g2o", device="cpu")
    save_g2o(pb, tmp_path / "port.g2o")
    assert (tmp_path / "port.g2o").read_text() == (tmp_path / "ref.g2o").read_text()
    assert ((tmp_path / "port.g2o.kernels").read_text()
            == (tmp_path / "ref.g2o.kernels").read_text())
    rb2 = r_load_g2o(tmp_path / "port.g2o")
    cfg = BACKENDS["dense"]
    want = r_optimize(rb2.to_arrays(v_capacity=CAP, e_capacity=CAP), level=0,
                      config=RConfig(**cfg))
    got = optimize_se2(pb.to_arrays(v_capacity=CAP, e_capacity=CAP), level=0,
                       config=SolverConfig(**cfg))
    _assert_same_solve(got, want, "g2o round trip")


def test_npz_round_trip(tmp_path):
    pb = builder_from_reference(_chain_first_graph())
    save_npz(pb, tmp_path / "g.npz")
    back = load_npz(tmp_path / "g.npz", device="cpu")
    assert len(back.poses) == len(pb.poses) and back.fixed == pb.fixed
    for a, b in zip(back.edges, pb.edges):
        assert (a["type"], a["i"], a["j"], a["level"], a["kernel"], a["delta"]) == (
            b["type"], b["i"], b["j"], b["level"], b["kernel"], b["delta"])
        np.testing.assert_array_equal(a["meas"], b["meas"])
        np.testing.assert_array_equal(a["info"], b["info"])


def test_unported_solver_paths_raise():
    pb = builder_from_reference(_ring())
    g = pb.to_arrays()
    # chain_segments is ported (parallel/spike.py) and, as in the JAX
    # package, only the fused chain-first LM reads it: on this table
    # layout the generic chain solve runs as without it, bit for bit
    seg, ss = optimize_se2(g, config=SolverConfig(backend="chain", chain_segments=4))
    whole, ws = optimize_se2(g, config=SolverConfig(backend="chain"))
    assert torch.equal(seg, whole) and ss.iterations == ws.iterations
    # chain_hubs > 0 is ported (graph/hub_solve.py): with the ring's last
    # vertex eliminated as a hub the solve lands where the dense one does
    # (chi2 within 1e-9 relative, poses within 1e-8)
    hub, hs = optimize_se2(g, config=dataclasses.replace(
        SolverConfig(backend="chain"), chain_hubs=1))
    dense, ds = optimize_se2(g, config=SolverConfig(backend="dense"))
    assert int(hs.n_offchain_dropped) == 0
    np.testing.assert_allclose(float(hs.chi2_final), float(ds.chi2_final),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(hub.numpy(), dense.numpy(), atol=1e-8)
