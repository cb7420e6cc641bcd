"""The graph solve and the line matcher on a card against the same calls
on the CPU. Imports torch and the port only, so that the card's machine
runs it without JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_card.py
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (numpy-only graph builders at the repo root)
from delta_graph_slam_tpu_torch.graph import SolverConfig, optimize_se2  # noqa: E402
from delta_graph_slam_tpu_torch.lines import (  # noqa: E402
    LineBasedScanmatcher, make_lines, transform_lines,
)
from delta_graph_slam_tpu_torch.ops import ransac  # noqa: E402
from delta_graph_slam_tpu_torch.ops.cloud import make_cloud  # noqa: E402


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_optimize_se2_on_card_matches_cpu(cuda_device):
    init, edges, _ = chip_smoke.bench_graph(512)
    cfg = SolverConfig(backend="chain", max_iterations=40)
    out = {}
    for dev in ("cpu", cuda_device):
        b = chip_smoke.graph_builder(init, edges, dev, dtype=np.float64)
        g = b.to_arrays(chain_first=True)
        out[str(dev)] = optimize_se2(g, level=0, config=cfg,
                                     off_hint=b.count_offchain(0),
                                     n_chain=g.poses.shape[0] - 1)
    (pc, sc), (pg, sg) = out["cpu"], out[str(cuda_device)]
    chi2_c, chi2_g = float(sc.chi2_final), float(sg.chi2_final)
    # float64 on both; sums run in another order on the card, so the same
    # final chi2 within 1e-9 relative, and the same poses within 1e-6 m/rad
    # when the LM took the same number of steps
    assert abs(chi2_g - chi2_c) <= 1e-9 * chi2_c, (chi2_g, chi2_c)
    if sg.iterations == sc.iterations:
        np.testing.assert_allclose(pg.cpu().numpy(), pc.numpy(), rtol=0, atol=1e-6)


def line_matcher_case():
    """A raycast keyframe's flat wall cloud (the port's own prefilter on the
    CPU), the city's outlines in its sensor frame from a map pose off by
    0.5 m / 0.03 rad, fixed RANSAC uniforms, and a small batch of
    (building, scan) pairs for align_local_batch. All numpy."""
    from delta_graph_slam_tpu_torch.config import get_preset
    from delta_graph_slam_tpu_torch.geom.host import se2_inverse_np, transform_2d_to_3d_np
    from delta_graph_slam_tpu_torch.io.kitti import make_city_world
    from delta_graph_slam_tpu_torch.io.lidar_sim import raycast_scan
    from delta_graph_slam_tpu_torch.models.prefiltering import PrefilteringStage

    world = make_city_world(seed=0)
    pose = np.array([-40.0, 0.5, 0.0])
    pre = get_preset("delta").prefiltering
    flat = PrefilteringStage(pre).process(raycast_scan(world, pose, seed=0)).filtered2d
    flat = (flat.points.numpy(), flat.mask.numpy())
    cfg = get_preset("delta").delta.scanmatcher
    u = np.random.default_rng(0).random((cfg.max_lines, cfg.n_hypotheses, 2)).astype(np.float32)
    near = [r for r in world.buildings if np.min(np.linalg.norm(r - pose[:2], axis=1)) < 35.0]
    a = np.concatenate(near)
    b = np.concatenate([np.roll(r, -1, axis=0) for r in near])
    inv = transform_2d_to_3d_np(se2_inverse_np(pose + [0.5, -0.3, 0.03]))
    bpose = [np.array([*r.mean(0), 0.0]) for r in near[:4]]
    Ts = np.float32([np.linalg.inv(transform_2d_to_3d_np(p)) for p in bpose])
    Tt = np.float32([T @ transform_2d_to_3d_np(pose) for T in Ts])
    return cfg, flat, u, (a, b, inv), near[:4], Ts, Tt


def run_line_matcher(device, case):
    cfg, flat, u, (a, b, inv), near, Ts, Tt = case
    sm = LineBasedScanmatcher(cfg, device, sampler=lambda *_: torch.from_numpy(u))
    cloud = make_cloud(flat[0], flat[1], device=device)
    lines = ransac.ransac_line(cloud, torch.from_numpy(u).to(device),
                               dist_thresh=cfg.sac_distance_threshold,
                               min_cluster_size=cfg.min_cluster_size,
                               max_cluster_size=cfg.max_cluster_size,
                               cluster_tolerance=cfg.cluster_tolerance,
                               merror_threshold=cfg.merror_threshold,
                               length_threshold=cfg.line_length_threshold)
    glob = sm.align_global(cloud, transform_lines(make_lines(a, b, capacity=cfg.max_target_lines),
                                                  inv), constrain_angle=True, max_range=3.5)
    src = [make_lines(r, np.roll(r, -1, axis=0), capacity=16, device=device) for r in near]
    src = type(src[0])(*(torch.stack(f) for f in zip(*src)))
    tgt = type(glob.not_aligned_lines)(*(f.expand((len(near),) + f.shape)
                                         for f in glob.not_aligned_lines))
    local = sm.align_local_batch(src, tgt, Ts, Tt, 0.5)
    out = {f"ransac.{k}": v for k, v in lines._asdict().items()}
    for name, res in (("global", glob), ("local", local)):
        out.update({f"{name}.lines.{k}": v for k, v in res.not_aligned_lines._asdict().items()})
        out.update({f"{name}.fitness.{k}": v for k, v in res.fitness._asdict().items()})
        out.update({f"{name}.{k}": getattr(res, k)
                    for k in ("transformation", "is_edge_aligned", "score")})
    return {k: v.cpu().numpy() for k, v in out.items()}


@pytest.mark.cuda
def test_line_matcher_on_card_matches_cpu(cuda_device):
    """ransac_line, align_global and align_local_batch with fixed uniforms:
    the same line masks on the card as on the CPU, transforms within 1e-4."""
    case = line_matcher_case()
    cpu = run_line_matcher("cpu", case)
    card = run_line_matcher(cuda_device, case)
    for k in ("ransac.mask", "global.lines.mask"):
        np.testing.assert_array_equal(card[k], cpu[k])
    assert cpu["ransac.mask"].sum() >= 3
    np.testing.assert_allclose(card["global.transformation"], cpu["global.transformation"],
                               rtol=0, atol=1e-4)
    np.testing.assert_allclose(card["local.transformation"], cpu["local.transformation"],
                               rtol=0, atol=1e-4)
    np.testing.assert_array_equal(card["local.is_edge_aligned"], cpu["local.is_edge_aligned"])


@pytest.mark.cuda
def test_line_matcher_on_card_is_deterministic(cuda_device):
    """ransac_line, align_global and align_local_batch twice on the card
    with the same inputs: every output bitwise equal. The building path has
    no float scatter-add, so nothing in it depends on the order of atomics."""
    case = line_matcher_case()
    first = run_line_matcher(cuda_device, case)
    second = run_line_matcher(cuda_device, case)
    assert first.keys() == second.keys()
    assert first["ransac.mask"].sum() >= 3
    for k in first:
        np.testing.assert_array_equal(second[k], first[k], err_msg=k)
