"""The port's parallel/ package (batched registration, MultiBagOdometry, the
mesh helpers and the sharded SE2 solve) against the JAX package's, and the
batched 1-NN kernel on a card.

Methods are named where the JAX package picks by platform
(``cov_method='knn'``). The card test imports no JAX and runs on a host
with a card (and no JAX) with

    python -m pytest --noconftest -m cuda tests/test_torch_parallel.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from delta_graph_slam_tpu_torch.ops import knn as P_knn
from delta_graph_slam_tpu_torch.ops import nn_kernel
from delta_graph_slam_tpu_torch.ops.cloud import make_cloud
from delta_graph_slam_tpu_torch.parallel import (
    MultiBagOdometry, batched_align, batched_align_sharded, make_mesh,
    optimize_se2_sharded, shard_graph_edges,
)
from delta_graph_slam_tpu_torch.parallel.multibag import _set_slice, _stack
from delta_graph_slam_tpu_torch.register.config import RegistrationConfig
from delta_graph_slam_tpu_torch.register.engine import make_registration

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]


def city_scan(n=4000, seed=0, sensor_height=1.8):
    """tests/test_models.py:city_scan: a ground plane and a wall."""
    rng = np.random.default_rng(seed)
    ground = np.stack([rng.uniform(-40, 40, n // 2), rng.uniform(-40, 40, n // 2),
                       np.full(n // 2, -sensor_height)], 1)
    wall = np.stack([rng.uniform(-40, 40, n - n // 2), np.full(n - n // 2, 12.0),
                     rng.uniform(-sensor_height, 4.0, n - n // 2)], 1)
    return (np.concatenate([ground, wall])
            + rng.normal(0, 0.01, (n, 3))).astype(np.float32)


B = 3
SPEEDS = [0.3, 0.5, 0.7]
MB_CFG = dict(method="FAST_GICP", maximum_iterations=20, chunk=512,
              correspondence_randomness=10, transformation_epsilon=1e-4,
              cov_method="knn")


def bag_frames(k, bases):
    return [bases[b] - np.float32([SPEEDS[b] * k, 0, 0]) for b in range(B)]


@pytest.mark.parametrize("nn_method", ["voxel", "brute"])
def test_multibag_odometry_matches_reference(nn_method):
    """tests/test_models.py:162's lockstep drive (B = 3 bags, capacity
    1280, four frames) through both packages."""
    from delta_graph_slam_tpu.ops import make_cloud as r_make_cloud
    from delta_graph_slam_tpu.parallel import MultiBagOdometry as RMultiBag
    from delta_graph_slam_tpu.register import RegistrationConfig as RRegConfig

    bases = [city_scan(n=1200, seed=s) for s in range(B)]
    ref = RMultiBag(RRegConfig(nn_method=nn_method, **MB_CFG), B,
                    keyframe_delta_trans=5.0, keyframe_delta_angle=5.0)
    port = MultiBagOdometry(RegistrationConfig(nn_method=nn_method, **MB_CFG), B,
                            keyframe_delta_trans=5.0, keyframe_delta_angle=5.0)
    for k in range(4):
        frames = bag_frames(k, bases)
        want = ref.process([r_make_cloud(f, capacity=1280) for f in frames])
        got = port.process([make_cloud(f, capacity=1280) for f in frames])
        # float32 GN in both packages on the same correspondences: poses
        # within 1e-4 m and 1e-5 of a rotation entry
        np.testing.assert_allclose(got[:, :3, 3], want[:, :3, 3], rtol=0, atol=1e-4)
        np.testing.assert_allclose(got[:, :3, :3], want[:, :3, :3], rtol=0, atol=1e-5)
    for b in range(B):
        assert abs(got[b][0, 3] - SPEEDS[b] * 3) < 0.1, b
    np.testing.assert_allclose(port.poses2d(got), ref.poses2d(want), rtol=0, atol=1e-4)
    assert port.initialized.all()


def test_multibag_swaps_keyframes_per_bag():
    """A bag whose motion passes the keyframe gate gets a new target (its
    row of the stacked model), the others keep theirs."""
    bases = [city_scan(n=1200, seed=s) for s in range(B)]
    port = MultiBagOdometry(RegistrationConfig(**MB_CFG), B,
                            keyframe_delta_trans=0.9, keyframe_delta_angle=5.0)
    first = [make_cloud(f, capacity=1280) for f in bag_frames(0, bases)]
    port.process(first)
    before = port.targets.points.clone()
    second = [make_cloud(f, capacity=1280) for f in bag_frames(2, bases)]
    odom = port.process(second)
    moved = [b for b in range(B) if SPEEDS[b] * 2 > 0.9]
    assert moved == [1, 2]
    assert torch.equal(port.targets.points[0], before[0])
    for b in moved:
        assert not torch.equal(port.targets.points[b], before[b])
        np.testing.assert_allclose(port.keyframe_poses[b], odom[b])
        np.testing.assert_array_equal(port.prev_trans[b], np.eye(4))


HEADS = {
    "icp_voxel": dict(method="ICP", nn_method="voxel"),
    "gicp_voxel": dict(method="FAST_GICP", nn_method="voxel"),
    "gicp_brute": dict(method="FAST_GICP", nn_method="brute", chunk=512),
    "vgicp": dict(method="FAST_VGICP", resolution=1.0),
    "ndt": dict(method="NDT_OMP", resolution=1.0),
}


def batch_problems(head, shifts=(0.3, 0.5, 0.7), yaw=0.02):
    cfg = RegistrationConfig(maximum_iterations=20, correspondence_randomness=10,
                             transformation_epsilon=1e-4, cov_method="knn",
                             **HEADS[head])
    reg = make_registration(cfg)
    tgts, srcs, guesses = [], [], []
    for b, s in enumerate(shifts):
        base = city_scan(n=1200, seed=b)
        c, sn = np.cos(yaw * b), np.sin(yaw * b)
        R = np.array([[c, -sn, 0], [sn, c, 0], [0, 0, 1]], np.float32)
        tgts.append(reg.build_target(make_cloud(base, capacity=1280)))
        srcs.append(reg.build_source(make_cloud(base @ R.T - np.float32([s, 0.1 * b, 0]),
                                                capacity=1280)))
        guesses.append(np.eye(4, dtype=np.float32))
    return reg, srcs, tgts, np.stack(guesses)


@pytest.mark.parametrize("head", list(HEADS))
def test_batched_align_matches_single_aligns(head):
    """Each problem of the batch iterates as its own align: the same
    iteration count and convergence, transforms within 1e-6 (float32
    products batched against unbatched)."""
    reg, srcs, tgts, guesses = batch_problems(head)
    res = batched_align(reg.cfg)(_stack(srcs), _stack(tgts), torch.from_numpy(guesses))
    assert res.transformation.shape == (B, 4, 4) and res.fitness.shape == (B,)
    for b in range(B):
        one = reg.align_pair(srcs[b], tgts[b], torch.from_numpy(guesses[b]))
        assert int(res.iterations[b]) == one.iterations, b
        assert bool(res.converged[b]) == one.converged, b
        assert int(res.num_correspondences[b]) == int(one.num_correspondences), b
        np.testing.assert_allclose(res.transformation[b].numpy(),
                                   one.transformation.numpy(), rtol=0, atol=1e-6)
        np.testing.assert_allclose(float(res.fitness[b]), float(one.fitness),
                                   rtol=1e-4, atol=1e-9)


def test_batched_align_freezes_converged_problems():
    """A problem already at its optimum stops after its first step and
    keeps its transform while the others iterate on."""
    reg, srcs, tgts, guesses = batch_problems("gicp_voxel", shifts=(0.0, 0.5, 0.7))
    res = batched_align(reg.cfg)(_stack(srcs), _stack(tgts), torch.from_numpy(guesses))
    its = res.iterations.tolist()
    assert its[0] < min(its[1:]) and bool(res.converged.all())
    one = reg.align_pair(srcs[0], tgts[0], torch.eye(4))
    assert its[0] == one.iterations
    np.testing.assert_allclose(res.transformation[0].numpy(), one.transformation.numpy(),
                               rtol=0, atol=1e-6)


def test_stack_and_set_slice_round_trip():
    reg, srcs, tgts, _ = batch_problems("vgicp")
    st = _stack(tgts)
    assert st.vh.means.shape[0] == B and st.vh.resolution == tgts[0].vh.resolution
    st = _set_slice(st, 1, tgts[2])
    assert torch.equal(st.vh.means[1], tgts[2].vh.means)
    assert torch.equal(st.voxel_covs[0], tgts[0].voxel_covs)


def test_make_mesh_shapes_and_limits():
    mesh = make_mesh(4, dp=2, mp=2, devices=["cpu"] * 4)
    assert mesh.shape == {"dp": 2, "mp": 2} and mesh.axis_names == ("dp", "mp")
    assert mesh.devices.shape == (2, 2) and mesh.home == torch.device("cpu")
    assert make_mesh(devices=["cpu"] * 3).shape == {"dp": 3, "mp": 1}
    with pytest.raises(ValueError, match="exist"):
        make_mesh(5, devices=["cpu"] * 4)
    with pytest.raises(ValueError, match="dp"):
        make_mesh(4, dp=3, mp=2, devices=["cpu"] * 4)
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="exist"):
            make_mesh(1)


def test_batched_align_sharded_on_a_cpu_mesh():
    """Contiguous chunks of the batch, one a 'dp' row, gathered back: the
    same results as the unsharded batched align."""
    reg, srcs, tgts, guesses = batch_problems("gicp_voxel")
    full = batched_align(reg.cfg)(_stack(srcs), _stack(tgts), torch.from_numpy(guesses))
    for dp in (1, 2, 3):
        run = batched_align_sharded(reg.cfg, make_mesh(dp, dp=dp, devices=["cpu"] * dp))
        got = run(_stack(srcs), _stack(tgts), guesses)
        assert run.mesh.shape["dp"] == dp
        np.testing.assert_allclose(got.transformation.numpy(),
                                   full.transformation.numpy(), rtol=0, atol=1e-6)
        assert torch.equal(got.iterations, full.iterations)


# -------------------------------------------------------- sharded graph solve

def bench_builders(n):
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from delta_graph_slam_tpu.graph import SE2GraphBuilder as RBuilder
    from delta_graph_slam_tpu_torch.interop import builder_from_reference

    init, edges, _ = chip_smoke.bench_graph(n)
    rb = RBuilder()
    for k, p in enumerate(init):
        rb.add_vertex(p, fixed=(k == 0))
    for i, j, m, kern in edges:
        rb.add_se2_edge(i, j, m, chip_smoke.GRAPH_INFO, kernel=kern, delta=1.0)
    return rb, builder_from_reference(rb)


def test_shard_graph_edges_pads_to_the_mesh_axis():
    _, pb = bench_builders(96)
    g = pb.to_arrays()
    mesh = make_mesh(4, dp=1, mp=4, devices=["cpu"] * 4)
    sg = shard_graph_edges(g, mesh)
    for name in ("edges", "priors_xy", "priors_yaw"):
        t, st = getattr(g, name), getattr(sg, name)
        n = t.i.shape[0]
        assert st.i.shape[0] % 4 == 0 and st.i.shape[0] - n < 4
        assert not st.mask[n:].any() and torch.equal(st.meas[:n], t.meas)
    assert torch.equal(sg.poses, g.poses)


@pytest.mark.parametrize("backend", ["chain", "cg"])
def test_optimize_se2_sharded_matches_reference(backend):
    """A 96-node two-lap graph over a 'mp' axis of 4: 'chain' solves it by
    4 SPIKE segments, 'cg' by the CG LM on the padded tables, in both
    packages."""
    from delta_graph_slam_tpu.graph import SolverConfig as RConfig
    from delta_graph_slam_tpu.parallel import make_mesh as r_make_mesh
    from delta_graph_slam_tpu.parallel import optimize_se2_sharded as r_sharded
    from delta_graph_slam_tpu_torch.graph import SolverConfig

    rb, pb = bench_builders(96)
    first = backend == "chain"
    rg, pg = rb.to_arrays(chain_first=first), pb.to_arrays(chain_first=first)
    nc = pg.poses.shape[0] - 1 if first else 0
    kw = dict(backend=backend, max_iterations=25, chain_offrank_capacity=8)
    wp, ws = r_sharded(rg, r_make_mesh(4, dp=1, mp=4), level=0, config=RConfig(**kw),
                       axis="mp", n_chain=nc)
    mesh = make_mesh(4, dp=1, mp=4, devices=["cpu"] * 4)
    gp, gs = optimize_se2_sharded(pg, mesh, level=0, config=SolverConfig(**kw),
                                  axis="mp", n_chain=nc)
    np.testing.assert_allclose(float(gs.chi2_initial), float(ws.chi2_initial), rtol=1e-9)
    # the segmented direct solve converges to the reference's optimum
    # (chi2 within 1e-6 relative, poses within 1e-4 m); the CG LM stops
    # where its inexact steps stop paying (chi2 within 1e-3 relative)
    rtol, atol = (1e-6, 1e-4) if first else (1e-3, 1e-2)
    np.testing.assert_allclose(float(gs.chi2_final), float(ws.chi2_final), rtol=rtol)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=0, atol=atol)


# ------------------------------------------------------- the batched 1-NN

def test_launch_geometry_accounts_for_the_batch():
    assert (nn_kernel.launch_geometry(32768, 32768, 132, 1)
            == nn_kernel.launch_geometry(32768, 32768, 132) == (4, 64))
    # eight problems of the fitness shape fill the card without a split
    assert nn_kernel.launch_geometry(32768, 32768, 132, 8) == (1, 64)
    assert nn_kernel.launch_geometry(1000, 32768, 132, 8) == (8, 2)
    with pytest.raises(ValueError):
        nn_kernel.launch_geometry(10, 10, 132, 0)


def test_batched_nn_1_plain_matches_per_problem_calls():
    """On CPU tensors nn_1 runs the plain version, batched as the kernel
    is: the same indices and distances (to float32 roundoff of the
    batched product) as one call a problem."""
    rng = np.random.default_rng(2)
    q = torch.from_numpy(rng.uniform(-5, 5, (3, 700, 3)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(-5, 5, (3, 900, 3)).astype(np.float32))
    qm = torch.from_numpy(rng.random((3, 700)) > 0.1)
    tm = torch.from_numpy(rng.random((3, 900)) > 0.2)
    before = nn_kernel.launches
    d2, idx = P_knn.nn_1(q, qm, t, tm, chunk=256)
    assert nn_kernel.launches == before and d2.shape == (3, 700)
    for b in range(3):
        d1, i1 = P_knn.nn_1(q[b], qm[b], t[b], tm[b], chunk=256)
        assert torch.equal(torch.isinf(d1), torch.isinf(d2[b]))
        fin = torch.isfinite(d1)
        assert torch.equal(i1[fin], idx[b][fin])
        assert float((d1[fin] - d2[b][fin]).abs().max()) <= 1e-5


# --------------------------------------------------------------- on the card

@pytest.mark.cuda
def test_batched_nn_1_kernel_on_card():
    """The batched kernel (one launch, problem index on blockIdx.z) against
    its plain version and against B single launches (bit for bit)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rng = np.random.default_rng(0)
    Bn, n, m = 5, 3000, 4100
    q = rng.uniform(-25, 25, (Bn, n, 3)).astype(np.float32)
    t = rng.uniform(-25, 25, (Bn, m, 3)).astype(np.float32)
    qm = rng.random((Bn, n)) > 0.1
    tm = rng.random((Bn, m)) > 0.2
    tm[3] = False                       # a problem with no valid target
    args = [torch.from_numpy(x).cuda() for x in (q, qm, t, tm)]
    before = nn_kernel.launches
    d2, idx = nn_kernel.nn_1_cuda(*args)
    assert nn_kernel.launches == before + 1 and d2.shape == (Bn, n)
    d2_r, idx_r = P_knn.nn_1_reference(*args)
    torch.cuda.synchronize()
    fin = torch.isfinite(d2_r)
    assert torch.equal(torch.isfinite(d2), fin)
    # float32 |q|^2 - 2 q.t + |t|^2 in both: 1e-3 m^2 at a street's extent
    assert float((d2[fin] - d2_r[fin]).abs().max()) <= 1e-3
    assert float((idx[fin] == idx_r[fin]).float().mean()) >= 0.99
    for b in range(Bn):
        d1, i1 = nn_kernel.nn_1_cuda(*(a[b].contiguous() for a in args))
        assert torch.equal(d1, d2[b]) and torch.equal(i1, idx[b]), b
    with pytest.raises(ValueError, match="must be"):
        nn_kernel.nn_1_cuda(args[0], args[1], args[2][:2], args[3][:2])
