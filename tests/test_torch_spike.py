"""The port's SPIKE segmented chain solve (delta_graph_slam_tpu_torch/
parallel/spike.py) against the JAX package's on the same numpy systems.

The cases are those of tests/test_spike.py: random SPD block-tridiagonal
systems whose condition grows like a SLAM chain's, plus K off-chain edges,
with a dense float64 solve as the ground truth. conftest.py turns x64 on,
so the JAX package's double-float blocks are float64 limbs; its solves are
jitted (one compile per shape, ~14 s each on a CPU) and compared, hi + lo
summed, with the port's native float64 ones. The LM-level route (the
automatic SPIKE solve of optimize_se2, the delta backend's hint) is in
test_torch_spike_lm.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delta_graph_slam_tpu.graph import SE2GraphBuilder as RBuilder
from delta_graph_slam_tpu.graph.df_linalg import dfm
from delta_graph_slam_tpu.parallel import spike as r_spike
from delta_graph_slam_tpu_torch.graph import SE2GraphBuilder
from delta_graph_slam_tpu_torch.graph.chain_solve import (
    bcr_apply, bcr_factor, chain_core_solve,
)
from delta_graph_slam_tpu_torch.parallel import spike

torch.set_num_threads(2)
r_core = jax.jit(r_spike.spike_core_solve_df, static_argnames=("N", "p", "mesh_axis"))
r_local = jax.jit(r_spike.spike_local_solve_df,
                  static_argnames=("N", "p", "Lc", "mesh_axis"))
INFO = np.diag([100.0, 100.0, 400.0])
# the port and the JAX package solve the same float64 systems by the same
# algebra (the JAX package in double-float limbs of float64): agreement to
# roundoff, here 1e-10 of the solution's largest entry
REL_REF = 1e-10
# against the dense float64 solve, whose own error grows with the
# condition of the chain: 1e-9 of the largest entry
REL_DENSE = 1e-9


def random_system(N=64, K=6, seed=0):
    """tests/test_spike.py:_random_system in float64: (A, B, b, off, x_ref)
    as numpy, off = (ei, ej, Ji, Jj, W), x_ref the dense float64 solve."""
    rng = np.random.default_rng(seed)
    D = 3
    B = rng.normal(0, 1.0, (N, D, D))
    B[0] = 0.0
    A = np.zeros((N, D, D))
    for k in range(N):
        A[k] += np.eye(D) * 0.05
        if k > 0:
            A[k] += B[k] @ B[k].T + np.eye(D) * np.abs(B[k]).sum() * 0.5
        if k < N - 1:
            A[k] += B[k + 1].T @ B[k + 1] + np.eye(D) * np.abs(B[k + 1]).sum() * 0.5
    ei = rng.integers(1, N - 1, K)
    ej = (ei + rng.integers(5, N // 2, K)) % N
    Ji = rng.normal(0, 0.5, (K, D, D))
    Jj = rng.normal(0, 0.5, (K, D, D))
    W = np.zeros((K, D, D))
    for k in range(K):
        M = rng.normal(0, 0.4, (D, D))
        W[k] = M @ M.T + 0.1 * np.eye(D)
    b = rng.normal(0, 1.0, (N, D))
    return A, B, b, (ei, ej, Ji, Jj, W)


def dense_solve(A, B, b, off):
    N, D = b.shape
    H = np.zeros((N * D, N * D))
    for k in range(N):
        H[k * D:(k + 1) * D, k * D:(k + 1) * D] += A[k]
        if k > 0:
            H[k * D:(k + 1) * D, (k - 1) * D:k * D] += B[k]
            H[(k - 1) * D:k * D, k * D:(k + 1) * D] += B[k].T
    ei, ej, Ji, Jj, W = off
    for k in range(len(ei)):
        C = np.zeros((D, N * D))
        C[:, ei[k] * D:(ei[k] + 1) * D] += Ji[k]
        C[:, ej[k] * D:(ej[k] + 1) * D] += Jj[k]
        H += C.T @ W[k] @ C
    return np.linalg.solve(H, b.reshape(-1)).reshape(N, D)


def port_args(A, B, b, off):
    t = torch.from_numpy
    off_t = None if off is None else (
        t(np.asarray(off[0], np.int64)), t(np.asarray(off[1], np.int64)),
        t(off[2]), t(off[3]), t(off[4]))
    return t(A), t(B), t(b), torch.ones(b.shape, dtype=torch.float64), off_t


def ref_args(A, B, b, off):
    off_j = None if off is None else (
        jnp.asarray(off[0], jnp.int32), jnp.asarray(off[1], jnp.int32),
        jnp.asarray(off[2]), jnp.asarray(off[3]), jnp.asarray(off[4]))
    return (dfm(jnp.asarray(A)), dfm(jnp.asarray(B)), jnp.asarray(b),
            jnp.ones(b.shape, jnp.float64), off_j)


def assert_close(got, want, rel, scale):
    err = np.max(np.abs(np.asarray(got) - np.asarray(want)))
    assert err <= rel * scale, (err, rel * scale)


# ------------------------------------------------------------ the core solve

def test_spike_core_matches_reference_chain_and_dense():
    N = 64
    A, B, b, off = random_system(N)
    x_dense = dense_solve(A, B, b, off)
    scale = np.abs(x_dense).max()
    Ap, Bp, bp, fp, offp = port_args(A, B, b, off)
    x_chain = chain_core_solve(Ap, Bp, bp, fp, N, off=offp).numpy()
    Ar, Br, br, fr, offr = ref_args(A, B, b, off)
    x_ref = np.asarray(r_core(Ar, Br, br, fr, N, p=4, off=offr))
    for p in (2, 4, 16):
        x = spike.spike_core_solve(Ap, Bp, bp, fp, N, p, off=offp).numpy()
        assert_close(x, x_dense, REL_DENSE, scale)
        assert_close(x, x_chain, REL_REF, scale)
        if p == 4:
            assert_close(x, x_ref, REL_REF, scale)


def test_spike_core_without_offchain_edges():
    N = 32
    A, B, b, _ = random_system(N, K=1)
    Ap, Bp, bp, fp, _ = port_args(A, B, b, None)
    Ar, Br, br, fr, _ = ref_args(A, B, b, None)
    x = spike.spike_core_solve(Ap, Bp, bp, fp, N, 4).numpy()
    x_chain = chain_core_solve(Ap, Bp, bp, fp, N).numpy()
    x_ref = np.asarray(r_core(Ar, Br, br, fr, N, p=4, off=None))
    scale = max(1.0, np.abs(x_chain).max())
    assert_close(x, x_chain, REL_REF, scale)
    assert_close(x, x_ref, REL_REF, scale)


def test_spike_core_pads_non_pow2_segments():
    # N=48 -> p=4 segments of 12 -> padded to 16 each
    N = 48
    A, B, b, off = random_system(N, K=3, seed=3)
    x_dense = dense_solve(A, B, b, off)
    Ap, Bp, bp, fp, offp = port_args(A, B, b, off)
    x = spike.spike_core_solve(Ap, Bp, bp, fp, N, 4, off=offp).numpy()
    Ar, Br, br, fr, offr = ref_args(A, B, b, off)
    x_ref = np.asarray(r_core(Ar, Br, br, fr, N, p=4, off=offr))
    scale = np.abs(x_dense).max()
    assert_close(x, x_dense, REL_DENSE, scale)
    assert_close(x, x_ref, REL_REF, scale)


@pytest.mark.parametrize("N,p", [(64, 4), (48, 4), (2048, 16), (4096, 16),
                                 (16384, 16), (100, 3), (5, 4), (96, 4)])
def test_segment_padding_matches_reference(N, p):
    """Segment length and padded size: the reference's rounding of m."""
    D = 3
    z = np.zeros((N, D, D))
    r = r_spike._pad_pow2_segments(dfm(jnp.asarray(z)), dfm(jnp.asarray(z)),
                                   jnp.zeros((N, D)), jnp.zeros((N, D)), N, p)
    t = spike._pad_pow2_segments(torch.zeros((N, D, D)), torch.zeros((N, D, D)),
                                 torch.zeros((N, D)), torch.zeros((N, D)), N, p)
    assert (t[4], t[5]) == (r[4], r[5])
    assert t[0].shape == r[0].hi.shape and t[3].shape == r[3].shape
    assert torch.equal(t[0][N:], torch.eye(D).expand(r[5] - N, D, D))


# ---------------------------------------------------- the locality-aware solve

def test_spike_local_matches_reference_core_and_dense():
    N = 64
    A, B, b, off = random_system(N)
    x_dense = dense_solve(A, B, b, off)
    scale = np.abs(x_dense).max()
    Ap, Bp, bp, fp, offp = port_args(A, B, b, off)
    x, n_drop = spike.spike_local_solve(Ap, Bp, bp, fp, N, 4, offp, 8)
    x_core = spike.spike_core_solve(Ap, Bp, bp, fp, N, 4, off=offp).numpy()
    Ar, Br, br, fr, offr = ref_args(A, B, b, off)
    x_ref, n_drop_ref = r_local(Ar, Br, br, fr, N, p=4, off=offr, Lc=8)
    assert int(n_drop) == int(n_drop_ref) == 0
    assert_close(x.numpy(), x_core, REL_REF, scale)
    assert_close(x.numpy(), x_dense, REL_DENSE, scale)
    assert_close(x.numpy(), np.asarray(x_ref), REL_REF, scale)


def test_spike_local_intra_segment_edge():
    """Both endpoints of every edge in ONE segment: the two endpoint slots
    of an edge meet in one capacitance column (the add of the two
    scatters)."""
    N = 64
    A, B, b, (_, _, Ji, Jj, W) = random_system(N, K=4, seed=5)
    off = (np.array([3, 7, 11, 2]), np.array([20, 29, 25, 17]), Ji, Jj, W)
    Ap, Bp, bp, fp, offp = port_args(A, B, b, off)
    x, n_drop = spike.spike_local_solve(Ap, Bp, bp, fp, N, 2, offp, 8)
    x_core = spike.spike_core_solve(Ap, Bp, bp, fp, N, 2, off=offp).numpy()
    Ar, Br, br, fr, offr = ref_args(A, B, b, off)
    x_ref, n_drop_ref = r_local(Ar, Br, br, fr, N, p=2, off=offr, Lc=8)
    scale = max(1.0, np.abs(x_core).max())
    assert int(n_drop) == int(n_drop_ref) == 0
    assert_close(x.numpy(), x_core, REL_REF, scale)
    assert_close(x.numpy(), dense_solve(A, B, b, off), REL_DENSE, scale)
    assert_close(x.numpy(), np.asarray(x_ref), REL_REF, scale)


def test_spike_local_overflow_drops_whole_edge():
    """Slot overflow drops complete edges: the solve equals the core solve
    with those edges zero-weighted, and the reference drops the same."""
    N = 64
    A, B, b, (_, _, Ji, Jj, W) = random_system(N, K=6, seed=9)
    # all i-endpoints in segment 0 (p=2, m=32): Lc=4 overflows
    off = (np.array([1, 2, 3, 4, 5, 6]), np.array([40, 45, 50, 55, 58, 60]),
           Ji, Jj, W)
    Ap, Bp, bp, fp, offp = port_args(A, B, b, off)
    x, n_drop = spike.spike_local_solve(Ap, Bp, bp, fp, N, 2, offp, 4)
    Ar, Br, br, fr, offr = ref_args(A, B, b, off)
    x_ref, n_drop_ref = r_local(Ar, Br, br, fr, N, p=2, off=offr, Lc=4)
    assert int(n_drop) == int(n_drop_ref) == 2
    # entries are packed by (segment, entry id): edges 4 and 5 overflow
    W_w = W.copy()
    W_w[4:] = 0.0
    off_w = port_args(A, B, b, off[:4] + (W_w,))[4]
    x_core = spike.spike_core_solve(Ap, Bp, bp, fp, N, 2, off=off_w).numpy()
    scale = max(1.0, np.abs(x_core).max())
    assert_close(x.numpy(), x_core, REL_REF, scale)
    assert_close(x.numpy(), np.asarray(x_ref), REL_REF, scale)


# ------------------------------------------------- slot accounting (host ints)

DROP_CASES = [
    # (ei, ej, live, N, p, Lc): tests/test_spike.py's accounting cases
    ([1, 2, 3, 4], [40, 45, 50, 55], [1, 1, 1, 1], 64, 4, 2),
    ([1, 2, 3, 4], [40, 45, 50, 55], [1, 1, 1, 1], 64, 4, 8),
    ([1, 2, 3, 4], [40, 45, 50, 55], [1, 1, 0, 0], 64, 4, 2),
    ([1, 2, 3, 4, 5, 130, 135], [100, 120, 140, 160, 200, 250, 245],
     [1] * 7, 256, 4, 5),
    ([1, 2, 3, 4, 5, 130, 135], [100, 120, 140, 160, 200, 250, 245],
     [1] * 7, 256, 4, 4),
    ([40], [70], [1], 96, 4, 1),
    ([3, 7, 11, 2, 60, 61], [20, 29, 25, 17, 62, 63], [1, 1, 1, 1, 1, 0], 64, 2, 3),
]


@pytest.mark.parametrize("case", range(len(DROP_CASES)))
def test_spike_local_dropped_matches_reference(case):
    ei, ej, live, N, p, Lc = DROP_CASES[case]
    want = int(r_spike.spike_local_dropped(
        jnp.asarray(ei, jnp.int32), jnp.asarray(ej, jnp.int32),
        jnp.asarray(live, bool), N, p, Lc))
    got = spike.spike_local_dropped(torch.tensor(ei), torch.tensor(ej),
                                    torch.tensor(live, dtype=torch.bool), N, p, Lc)
    assert int(got) == want


def loop_builders(n, loops, extra=()):
    """The same chain + loop graph in both packages' builders."""
    out = []
    for cls, kw in ((RBuilder, {}), (SE2GraphBuilder, {"device": "cpu"})):
        b = cls(**kw)
        for k in range(n):
            b.add_vertex(np.asarray([k * 1.0, 0.0, 0.0]), fixed=(k == 0))
        for k in range(n - 1):
            b.add_se2_edge(k, k + 1, np.asarray([1.0, 0.0, 0.0]), INFO)
        for i, j in loops:
            b.add_se2_edge(i, j, np.asarray([float(j - i), 0.0, 0.0]), INFO,
                           kernel="Huber", delta=1.0)
        for i, j, level in extra:
            b.add_se2_edge(i, j, np.zeros(3), np.eye(3), level=level)
        out.append(b)
    return out


@pytest.mark.parametrize("n,loops,extra,cap,p", [
    (256, [(1, 100), (2, 120), (3, 140), (4, 160), (5, 200), (130, 250),
           (135, 245)], (), 256, 4),
    (256, [(1, 100)], ((10, 200, 1), (0, 150, 0)), 256, 4),
    (96, [(40, 70)], (), 96, 4),
    (3000, [(k, k + 1500) for k in range(0, 1500, 100)], ((5, 2900, 1),), 4096, 16),
])
def test_spike_local_need_matches_reference(n, loops, extra, cap, p):
    rb, pb = loop_builders(n, loops, extra)
    for level in (0, 1):
        assert pb.spike_local_need(cap, level, p) == rb.spike_local_need(cap, level, p)


# ------------------------------------------------------- the batched BCR

def test_batched_bcr_factor_matches_unbatched_calls():
    """p segments factored in one batched pass hold the bits of p
    unbatched factorizations; the sweep agrees to float64 roundoff (its
    base solve is a batched product where the unbatched one is a plain
    one)."""
    A, B, b, _ = random_system(64, K=1, seed=4)
    p, m = 4, 16
    As = torch.from_numpy(A).reshape(p, m, 3, 3)
    Bs = torch.from_numpy(B).reshape(p, m, 3, 3).clone()
    Bs[:, 0] = 0.0
    g = torch.from_numpy(np.random.default_rng(1).normal(size=(p, m, 3, 5)))
    for base in (1, 4):
        levels, base_inv = bcr_factor(As, Bs, base_blocks=base)
        x = bcr_apply((levels, base_inv), g)
        for s in range(p):
            levels_s, base_s = bcr_factor(As[s], Bs[s], base_blocks=base)
            assert len(levels_s) == len(levels)
            for lb, ls in zip(levels, levels_s):
                assert all(torch.equal(u[s], v) for u, v in zip(lb, ls))
            assert torch.equal(base_inv[s], base_s)
            xs = bcr_apply((levels_s, base_s), g[s])
            # float64 roundoff of the base product: 1e-13 of the largest entry
            assert float((x[s] - xs).abs().max()) <= 1e-13 * float(xs.abs().max())
