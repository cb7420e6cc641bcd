"""Parity of the port's NDT and VGICP registration heads
(register/engine.py) with the JAX package, on the CPU.

Two consecutive raycast scans (0.3 m apart) are prefiltered once by the port
at the small_delta_cfg scale (raw 16384, out 4096); the same float32 arrays
then go through both packages: the target model (voxel statistics, the
regularized voxel covariances and the NDT inverses), one residual pass at a
fixed transform, and a whole alignment. The methods are named: NDT_OMP with
DIRECT7 and DIRECT1 neighbourhoods, FAST_VGICP (27 cells), kNN source
covariances through the voxel hash.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delta_graph_slam_tpu import ops as R_ops
from delta_graph_slam_tpu.register import engine as r_engine
from delta_graph_slam_tpu.register.config import RegistrationConfig as RCfg
from delta_graph_slam_tpu_torch.config import get_preset
from delta_graph_slam_tpu_torch.io.lidar_sim import raycast_city_sequence
from delta_graph_slam_tpu_torch.models.prefiltering import PrefilteringStage
from delta_graph_slam_tpu_torch.ops.cloud import make_cloud
from delta_graph_slam_tpu_torch.ops.voxel import build_voxel_hash
from delta_graph_slam_tpu_torch.ops.voxel_knn import voxel_knn
from delta_graph_slam_tpu_torch.register import engine as p_engine
from delta_graph_slam_tpu_torch.register.config import (
    REGISTRATION_PRESETS, RegistrationConfig,
)

from test_torch_ops import _well_conditioned  # noqa: E402

torch.set_num_threads(2)

CAPACITY_VOXELS = 4096
HEADS = {
    "NDT_OMP_DIRECT7": dict(method="NDT_OMP", nn_search_method="DIRECT7"),
    "NDT_OMP_DIRECT1": dict(method="NDT_OMP", nn_search_method="DIRECT1"),
    "FAST_VGICP": dict(method="FAST_VGICP"),
}


def configs(name):
    """(reference config, port config): resolution 1.0 as the hdl preset,
    30 GN iterations, brute chunk 1024, kNN covariances named."""
    kw = dict(HEADS[name], resolution=1.0, maximum_iterations=30, chunk=1024,
              cov_method="knn")
    return RCfg(**kw), RegistrationConfig(**kw)


@pytest.fixture(scope="module")
def scans():
    """The port's prefiltered 3-D clouds of two consecutive frames, as numpy."""
    _, frames = raycast_city_sequence(n_frames=2, speed=3.0)
    cfg = get_preset("delta").prefiltering
    stage = PrefilteringStage(dataclasses.replace(
        cfg, raw_capacity=16384, out_capacity=4096, chunk=1024,
        neighbor_method="voxel"), device="cpu")
    out = []
    for fr in frames:
        c = stage.process(fr.points, base_T=np.eye(4)).filtered3d
        out.append((c.points.numpy(), c.mask.numpy()))
    return out


def models(name, scans):
    """Both packages' target and source models of the two scans."""
    rcfg, pcfg = configs(name)
    (tp, tm), (sp, sm) = scans
    r = (r_engine._build_target_model(rcfg, CAPACITY_VOXELS, R_ops.make_cloud(tp, tm)),
         r_engine._build_source_model(rcfg, CAPACITY_VOXELS, R_ops.make_cloud(sp, sm)))
    p = (p_engine._build_target_model(pcfg, CAPACITY_VOXELS, make_cloud(tp, tm)),
         p_engine._build_source_model(pcfg, CAPACITY_VOXELS, make_cloud(sp, sm)))
    return r, p


def well_conditioned(raw_covs):
    """Covariances whose smallest eigenvector is defined to float32: the gap
    between the two smallest eigenvalues above 5 % of the largest. 'plane'
    regularization keeps only that eigenvector, which float32 rounding
    turns freely where the gap closes (a line-like or isotropic voxel)."""
    lam = np.linalg.eigvalsh(np.asarray(raw_covs, np.float64))
    return (lam[:, 1] - lam[:, 0]) > 0.05 * np.maximum(lam[:, 2], 1e-12)


def source_well_conditioned(pcfg, sp, sm):
    """Source points (in the NN hash's order) whose kNN neighbourhood has a
    defined normal (tests/test_torch_ops.py:_well_conditioned)."""
    vh = build_voxel_hash(make_cloud(sp, sm), pcfg.nn_voxel_resolution,
                          CAPACITY_VOXELS, dense_index=True, with_stats=False)
    _, idx, valid = voxel_knn(vh, vh.sorted_points, vh.sorted_valid,
                              pcfg.correspondence_randomness,
                              p_engine._neighbor_offsets(pcfg.cov_voxel_cells),
                              pcfg.cov_voxel_window)
    return _well_conditioned(vh.sorted_points.numpy()[idx.numpy()], valid.numpy())


def test_presets_name_the_heads():
    assert REGISTRATION_PRESETS["hdl"].head == "ndt"
    assert REGISTRATION_PRESETS["hdl"].neighbor_offsets == 7
    assert configs("NDT_OMP_DIRECT1")[1].neighbor_offsets == 1
    assert configs("FAST_VGICP")[1].neighbor_offsets == 27
    # the reference approximates KDTREE by DIRECT7, and so does the port
    assert RegistrationConfig(nn_search_method="KDTREE").neighbor_offsets == 7
    for resolution, outlier_ratio in ((1.0, 0.55), (0.5, 0.55), (2.0, 0.3)):
        assert (p_engine._ndt_gauss_d2(resolution, outlier_ratio)
                == r_engine._ndt_gauss_d2(resolution, outlier_ratio))


@pytest.mark.parametrize("name", list(HEADS))
def test_target_model_matches_reference(name, scans):
    (rt, rs), (pt, ps) = models(name, scans)
    _, pcfg = configs(name)
    sp, sm = scans[1]
    counts = pt.vh.counts.numpy()
    np.testing.assert_array_equal(counts, np.asarray(rt.vh.counts))   # exact counts
    np.testing.assert_array_equal(pt.vh.keys.numpy(), np.asarray(rt.vh.keys))
    occ = counts > 0
    assert occ.sum() > 200
    if name == "FAST_VGICP":
        occ &= well_conditioned(rt.vh.covs) | (counts < 5)
        assert (occ & (counts >= 5)).sum() > 80
    # voxel means: float32 sums in the same order, within 1e-5 m
    np.testing.assert_allclose(pt.vh.means.numpy()[occ], np.asarray(rt.vh.means)[occ],
                               rtol=0, atol=1e-5)
    # regularized covariances: unit-scale ('plane', well-conditioned voxels)
    # or at most the voxel's extent squared ('floor'): within 2e-3 absolute
    np.testing.assert_allclose(pt.voxel_covs.numpy()[occ],
                               np.asarray(rt.voxel_covs)[occ], rtol=0, atol=2e-3)
    gated = counts < 5
    assert (pt.voxel_covs.numpy()[gated] == np.eye(3)).all()
    if pt.voxel_inv_covs is not None:
        inv_p, inv_r = pt.voxel_inv_covs.numpy(), np.asarray(rt.voxel_inv_covs)
        assert (inv_p[gated] == 0).all()
        good = ~gated
        # inverses of covariances with condition <= 100: relative to the
        # voxel's largest entry, within 1e-3
        scale = np.abs(inv_r[good]).max(axis=(1, 2), keepdims=True)
        assert (np.abs(inv_p[good] - inv_r[good]) <= 1e-3 * scale).all()
    else:
        assert rt.voxel_inv_covs is None
    if ps.covs is not None:       # vgicp: kNN source covariances, hash order
        np.testing.assert_array_equal(ps.mask.numpy(), np.asarray(rs.mask))
        np.testing.assert_allclose(ps.points.numpy(), np.asarray(rs.points), atol=0)
        m = ps.mask.numpy()
        good = m & source_well_conditioned(pcfg, sp, sm)
        assert good.sum() > 0.6 * m.sum()
        # plane-regularized (unit eigenvalues) where the normal is defined:
        # within 1e-3, as tests/test_torch_ops.py holds the GICP covariances
        np.testing.assert_allclose(ps.covs.numpy()[good], np.asarray(rs.covs)[good],
                                   rtol=0, atol=1e-3)


@pytest.mark.parametrize("name", list(HEADS))
def test_evaluate_matches_reference(name, scans):
    """One residual pass at the true frame motion: the same hits, residuals
    and information matrices."""
    (rt, rs), (pt, ps) = models(name, scans)
    rcfg, pcfg = configs(name)
    T = np.eye(4, dtype=np.float32)
    T[0, 3] = -0.29
    r_find, r_eval = r_engine._make_correspondence_fns(rcfg)
    p_find, p_eval = p_engine._make_correspondence_fns(pcfg)
    Tj, Tp = jnp.asarray(T), torch.from_numpy(T)
    rp, rr, rM, rv = (np.asarray(x) for x in r_eval(Tj, r_find(Tj, rs, rt), rs, rt))
    pp, pr, pM, pv = (x.numpy() for x in p_eval(Tp, p_find(Tp, ps, pt), ps, pt))
    m = pcfg.neighbor_offsets
    assert pv.shape == (ps.points.shape[0] * m,)
    np.testing.assert_array_equal(pv, rv)                      # the same pairs
    assert pv.sum() > 1000
    np.testing.assert_allclose(pp[pv], rp[rv], rtol=0, atol=1e-5)   # points: 1e-5 m
    np.testing.assert_allclose(pr[pv], rr[rv], rtol=0, atol=1e-5)   # residuals: 1e-5 m
    cmp = pv.copy()
    if name == "FAST_VGICP":
        # plane covariances are compared where both normals are defined:
        # the source point's neighbourhood and the voxel (or a gated voxel)
        slot = p_find(Tp, ps, pt)[0].reshape(-1).numpy()
        raw = np.asarray(rt.vh.covs)
        vox_ok = well_conditioned(raw) | (np.asarray(rt.vh.counts) < 5)
        src_ok = source_well_conditioned(pcfg, *scans[1]).repeat(m)
        cmp &= vox_ok[slot] & src_ok
        assert cmp.sum() > 0.5 * pv.sum()
    # information: within 2e-3 of each matrix's largest entry, and 1e-5 of
    # the largest anywhere (NDT weights that underflow towards zero)
    scale = np.maximum(np.abs(rM[cmp]).max(axis=(1, 2), keepdims=True),
                       5e-3 * np.abs(rM[cmp]).max())
    assert (np.abs(pM[cmp] - rM[cmp]) <= 2e-3 * scale).all()
    # the normal equations they feed: within 1e-3 relative of H's scale
    Hp, bp, _ = p_engine._normal_equations(*(torch.from_numpy(x) for x in (pp, pr, pM, cmp)))
    Hr, br, _ = r_engine._normal_equations(*(jnp.asarray(x) for x in (rp, rr, rM, cmp)))
    Hr, br = np.asarray(Hr), np.asarray(br)
    np.testing.assert_allclose(Hp.numpy(), Hr, rtol=0, atol=1e-3 * np.abs(Hr).max())
    np.testing.assert_allclose(bp.numpy(), br, rtol=0, atol=1e-3 * np.abs(Hr).max())


def structured_scene(n=1200, seed=3):
    """tests/test_register.py's walls + ground scene and its source, moved
    by exp(-xi), xi = (0.3, -0.2, 0.05, 0.01, -0.02, 0.06)."""
    rng = np.random.default_rng(seed)
    n1 = n // 3
    ground = np.stack([rng.uniform(-15, 15, n1), rng.uniform(-15, 15, n1),
                       np.zeros(n1)], 1)
    wall1 = np.stack([rng.uniform(-15, 15, n1), np.full(n1, 8.0),
                      rng.uniform(0, 5, n1)], 1)
    wall2 = np.stack([np.full(n - 2 * n1, -10.0), rng.uniform(-15, 15, n - 2 * n1),
                      rng.uniform(0, 5, n - 2 * n1)], 1)
    tgt = np.concatenate([ground, wall1, wall2])
    tgt = tgt + rng.normal(0, 0.01, tgt.shape)
    T = np.asarray(r_engine.se3_exp(jnp.asarray([-0.3, 0.2, -0.05, -0.01, 0.02, -0.06])))
    src = tgt @ T[:3, :3].T + T[:3, 3]
    pad = np.zeros((1280 - n, 3))
    mask = np.arange(1280) < n
    return (np.concatenate([tgt, pad]).astype(np.float32), mask,
            np.concatenate([src, pad]).astype(np.float32), mask)


def aligned(cfg_r, cfg_p, capacity, tgt, src, guess):
    """Both packages' RegistrationResult of one alignment, as numpy."""
    out = []
    for reg, cloud in ((r_engine.Registration(cfg_r, capacity_voxels=capacity),
                        R_ops.make_cloud),
                       (p_engine.Registration(cfg_p, capacity_voxels=capacity),
                        make_cloud)):
        reg.set_target(cloud(*tgt))
        res = reg.align(cloud(*src), guess.astype(np.float32))
        out.append((np.asarray(res.transformation, np.float64)
                    if not isinstance(res.transformation, torch.Tensor)
                    else res.transformation.numpy().astype(np.float64),
                    bool(res.converged), int(res.iterations),
                    int(res.num_correspondences), float(res.fitness)))
    return out


def assert_same_alignment(r, p, min_motion, atol_m=1e-3, atol_rad=1e-4):
    (T_r, conv_r, it_r, n_r, fit_r), (T_p, conv_p, it_p, n_p, fit_p) = r, p
    assert conv_p == conv_r
    assert np.linalg.norm(T_r[:3, 3]) > min_motion
    # one GN step more or fewer where the last step straddles the epsilon
    assert abs(it_p - it_r) <= 1, (it_p, it_r)
    # transform within atol_m and atol_rad (rotation angle from the skew part)
    np.testing.assert_allclose(T_p[:3, 3], T_r[:3, 3], rtol=0, atol=atol_m)
    dR = T_p[:3, :3].T @ T_r[:3, :3]
    assert np.linalg.norm(dR - dR.T) / (2 * np.sqrt(2)) < atol_rad
    assert n_p == pytest.approx(n_r, rel=1e-2)                # counts within 1 %
    np.testing.assert_allclose(fit_p, fit_r, rtol=5e-3)


@pytest.mark.parametrize("name", list(HEADS))
def test_alignment_matches_reference(name, scans):
    """The raycast pair, 0.29 m apart along the street. VGICP recovers it
    from the identity. NDT does not, in either package: its exponential
    weight gives no pull across a 1 m wall voxel whose floored covariance
    is ~3 cm thick, and the walls run along the motion; from a guess 4 cm
    off, as a prediction would give, it converges."""
    rcfg, pcfg = configs(name)
    guess = np.eye(4)
    if name.startswith("NDT"):
        r, p = aligned(rcfg, pcfg, CAPACITY_VOXELS, scans[0], scans[1], guess)
        for T, conv, its, _, _ in (r, p):
            assert conv and its == 1 and np.linalg.norm(T[:3, 3]) < 0.01
        guess[:2, 3] = [0.25, 0.02]
    r, p = aligned(rcfg, pcfg, CAPACITY_VOXELS, scans[0], scans[1], guess)
    assert_same_alignment(r, p, 0.25)


@pytest.mark.parametrize("name", list(HEADS))
def test_structured_scene_alignment_matches_reference(name):
    """tests/test_register.py's recovery case at resolution 2.0 from the
    identity, on both packages."""
    kw = dict(HEADS[name], resolution=2.0, maximum_iterations=50,
              max_correspondence_distance=2.5, correspondence_randomness=15,
              chunk=512, transformation_epsilon=1e-4, cov_method="knn")
    tp, tm, sp, sm = structured_scene()
    r, p = aligned(RCfg(**kw), RegistrationConfig(**kw), 2048, (tp, tm), (sp, sm),
                   np.eye(4))
    # VGICP's plane covariances of the scene's noisy kNN neighbourhoods
    # differ where float32 rounding turns a normal (see the target test):
    # within 5 mm / 2e-3 rad of each other there, against the O(resolution
    # / 20) = 0.1 m bias the voxel heads carry; NDT within 1e-3 m / 1e-4 rad
    tol = (5e-3, 2e-3) if name == "FAST_VGICP" else (1e-3, 1e-4)
    assert_same_alignment(r, p, 0.3, *tol)
