"""The graph solve on a card against the same solve on the CPU. Imports
torch and the port only, so that the card's machine runs it without JAX:

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
