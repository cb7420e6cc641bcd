"""Parity of the port's prefiltering, registration and information
matrices with the JAX package, on the CPU, at the small_delta_cfg scale
(raw 16384, out 4096, chunk 1024, at most 30 GN iterations).

Both sides get the same float32 scans and name their methods: the
reference's 'auto' switches pick other paths on a TPU.
"""

import dataclasses

import numpy as np
import pytest
import torch

from delta_graph_slam_tpu import ops as R_ops
from delta_graph_slam_tpu.config import get_preset as r_get_preset
from delta_graph_slam_tpu.models.prefiltering import PrefilteringStage as RStage
from delta_graph_slam_tpu.pipeline.information_matrix import (
    fitness_score as r_fitness,
)
from delta_graph_slam_tpu.register import Registration as RReg
from delta_graph_slam_tpu_torch.config import get_preset as p_get_preset
from delta_graph_slam_tpu_torch.io.lidar_sim import raycast_city_sequence
from delta_graph_slam_tpu_torch.models.hdl_backend import HdlBackendConfig
from delta_graph_slam_tpu_torch.models.prefiltering import PrefilteringStage as PStage
from delta_graph_slam_tpu_torch.models.scan_matching_odometry import (
    ScanMatchingOdometry,
)
from delta_graph_slam_tpu_torch.ops.cloud import make_cloud
from delta_graph_slam_tpu_torch.pipeline.information_matrix import (
    fitness_score as p_fitness,
)
from delta_graph_slam_tpu_torch.register.engine import Registration as PReg

torch.set_num_threads(2)


def np_(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _small(get_preset):
    cfg = get_preset("delta")
    pre = dataclasses.replace(cfg.prefiltering, raw_capacity=16384,
                              out_capacity=4096, chunk=1024,
                              neighbor_method="voxel")
    reg = dataclasses.replace(cfg.odometry.registration, chunk=1024,
                              maximum_iterations=30, cov_method="knn")
    return pre, reg


@pytest.fixture(scope="module")
def frames():
    _, frames = raycast_city_sequence(n_frames=2, speed=3.0)
    return frames


@pytest.fixture(scope="module")
def filtered(frames):
    """Reference prefilter outputs of two consecutive frames (0.3 m apart),
    as numpy."""
    stage = RStage(_small(r_get_preset)[0])
    out = []
    for fr in frames:
        o = stage.process(fr.points, base_T=np.eye(4))
        out.append(tuple((np.asarray(c.points), np.asarray(c.mask))
                         for c in (o.filtered3d, o.filtered2d)))
    return out


def test_prefiltering_matches_reference(frames, filtered):
    stage = PStage(_small(p_get_preset)[0], device="cpu")
    for fr, ref in zip(frames, filtered):
        out = stage.process(fr.points, base_T=np.eye(4))
        for (rp, rm), c in zip(ref, (out.filtered3d, out.filtered2d)):
            pp, pm = np_(c.points), np_(c.mask)
            # equal counts, and the same points slot by slot within 1e-5 m
            assert pm.sum() == rm.sum() and pm.sum() > 100
            np.testing.assert_array_equal(pm, rm)
            np.testing.assert_allclose(pp[pm], rp[rm], atol=1e-5)


@pytest.mark.parametrize("nn_method", ["voxel", "brute"])
def test_registration_matches_reference(filtered, nn_method):
    (tp, tm), _ = filtered[0]
    (sp, sm), _ = filtered[1]
    results = []
    for get_preset, reg_cls, cloud in (
        (r_get_preset, RReg, lambda p, m: R_ops.make_cloud(p, m)),
        (p_get_preset, PReg, lambda p, m: make_cloud(p, m)),
    ):
        cfg = dataclasses.replace(_small(get_preset)[1], nn_method=nn_method)
        reg = reg_cls(cfg, capacity_voxels=4096)
        reg.set_target(cloud(tp, tm))
        res = reg.align(cloud(sp, sm), np.eye(4, dtype=np.float32))
        results.append((np_(res.transformation).astype(np.float64),
                        int(res.iterations), bool(res.converged),
                        float(res.fitness)))
    (T_r, it_r, conv_r, fit_r), (T_p, it_p, conv_p, fit_p) = results
    assert conv_r and conv_p
    assert it_p == it_r                          # the same iteration count
    assert np.linalg.norm(T_r[:3, 3]) > 0.25     # a real 0.3 m motion
    # transform within 1e-3 m and 1e-4 rad (rotation angle from the skew
    # part: the trace of float32 rotations is not accurate enough)
    np.testing.assert_allclose(T_p[:3, 3], T_r[:3, 3], atol=1e-3)
    dR = T_p[:3, :3].T @ T_r[:3, :3]
    assert np.linalg.norm(dR - dR.T) / (2 * np.sqrt(2)) < 1e-4
    # fitness is a mean over the correspondences inside the 2 m gate: one
    # pair entering or leaving it moves the mean by ~1e-3, so rtol 5e-3
    np.testing.assert_allclose(fit_p, fit_r, rtol=5e-3)


def test_fitness_and_information_match_reference(filtered):
    (p1, m1), _ = filtered[0]
    (p2, m2), _ = filtered[1]
    T_small = np.eye(4)
    T_small[:3, 3] = [0.05, -0.02, 0.0]
    rel = np.eye(4)
    rel[0, 3] = -0.29                          # about the true frame motion
    cases = [(p1, m1, p2, m2, rel), (p1, m1, p1, m1, T_small)]
    pcal = p_get_preset("delta").delta.inf
    rcal = r_get_preset("delta").delta.inf
    p_items, r_items = [], []
    for a, am, b, bm, T in cases:
        rc1, rc2 = R_ops.make_cloud(a, am), R_ops.make_cloud(b, bm)
        pc1, pc2 = make_cloud(a, am), make_cloud(b, bm)
        for max_range in (float("inf"), 0.25):
            f_r = r_fitness(rc1, rc2, T, max_range)
            f_p = p_fitness(pc1, pc2, T, max_range)
            # mean squared 1-NN distance: rtol 1e-4
            np.testing.assert_allclose(f_p, f_r, rtol=1e-4)
        r_items.append((rc1, rc2, T))
        p_items.append((pc1, pc2, T))
    infos_r = rcal.calc_information_matrices(r_items)
    infos_p = pcal.calc_information_matrices(p_items)
    for ip, ir in zip(infos_p, infos_r):
        np.testing.assert_allclose(ip, ir, rtol=1e-4)  # information: rtol 1e-4
    # the small-offset pair lands on the unsaturated part of the weight curve
    assert infos_p[1][0, 0] > 2 * infos_p[0][0, 0]
    for ip, ir in zip(pcal.calc_information_matrices_se3(p_items),
                      rcal.calc_information_matrices_se3(r_items)):
        np.testing.assert_allclose(ip, ir, rtol=1e-4)  # 6x6 variant: rtol 1e-4


def test_odometry_state_round_trip(filtered, tmp_path):
    """save_state/load_state: a restored odometry aligns the next frame to
    the same pose (the reloaded keyframe is the same compacted cloud)."""
    _, reg = _small(p_get_preset)
    cfg = dataclasses.replace(p_get_preset("delta").odometry, registration=reg)
    clouds = [make_cloud(p, m) for (p, m), _ in filtered]
    a = ScanMatchingOdometry(cfg, device="cpu")
    a.matching(0.0, clouds[0])
    a.save_state(tmp_path / "odo.npz")
    b = ScanMatchingOdometry(cfg, device="cpu")
    b.load_state(tmp_path / "odo.npz", capacity=clouds[0].capacity)
    fa, fb = a.matching(0.1, clouds[1]), b.matching(0.1, clouds[1])
    assert fa.converged and fb.converged and fa.iterations == fb.iterations
    np.testing.assert_allclose(fb.pose, fa.pose, atol=1e-6)


def test_colored_by_order_matches_reference():
    from delta_graph_slam_tpu.models.prefiltering import colored_by_order as r_colored
    from delta_graph_slam_tpu_torch.models.prefiltering import colored_by_order

    for n in (0, 1, 7, 1000):
        pts = np.zeros((n, 3), np.float32)
        got = colored_by_order(pts)
        assert got.dtype == np.uint8 and got.shape == (n, 3)
        np.testing.assert_array_equal(got, r_colored(pts))


def test_unported_methods_raise(filtered):
    """Unknown covariance and neighbour methods and an unknown preset raise.
    The 'dense' methods (ops/moments.py; tests/test_torch_moments.py holds
    them to the reference), the vgicp / ndt heads, the nodelet-default NDT
    registration and the deskewing prefilter run."""
    _, reg = _small(p_get_preset)
    for cfg in (dataclasses.replace(reg, cov_method="nope"),
                dataclasses.replace(reg, method="FAST_VGICP", cov_method="nope")):
        with pytest.raises(ValueError, match="nope"):
            PReg(cfg)
        assert PReg(dataclasses.replace(cfg, cov_method="dense")).cfg.cov_method == "dense"
    pre, _ = _small(p_get_preset)
    with pytest.raises(ValueError, match="nope"):
        PStage(dataclasses.replace(pre, neighbor_method="nope"), device="cpu")
    assert PStage(dataclasses.replace(pre, neighbor_method="dense"),
                  device="cpu").cfg.neighbor_method == "dense"
    with pytest.raises(KeyError):
        p_get_preset("hdl_999")
    assert p_get_preset("hdl_400").hdl is not None
    (tp, tm), _ = filtered[0]
    (sp, sm), _ = filtered[1]
    guess = np.eye(4, dtype=np.float32)
    guess[0, 3] = 0.25              # NDT converges from near the motion
    for cfg in (dataclasses.replace(reg, method="FAST_VGICP"),
                dataclasses.replace(reg, method="NDT_OMP"),
                HdlBackendConfig().registration):
        r = PReg(cfg, capacity_voxels=4096)
        r.set_target(make_cloud(tp, tm))
        res = r.align(make_cloud(sp, sm), guess)
        assert res.converged and int(res.num_correspondences) > 1000
        assert 0.25 < float(res.transformation[0, 3]) < 0.35     # the 0.3 m motion
    frame = filtered[0][0][0]
    out = PStage(dataclasses.replace(pre, deskewing=True), device="cpu").process(
        np.concatenate([frame, frame]), angular_velocity=[0.0, 0.0, 1.0])
    assert int(out.filtered3d.mask.sum()) > 100
