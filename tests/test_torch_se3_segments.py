"""SE3 solves with ``chain_segments`` set: both packages solve the graph
as without it.

The JAX package's SE3 LM takes the hub-elimination path whenever the
graph has hub vertices (graph/lm_core.py:316) and the whole-chain solve
otherwise, whatever ``chain_segments`` says (the segmented SPIKE solve is
an SE2 route). The port's optimize_se3 does the same. The JAX package's
chain program compiles once here (~70 s on a CPU).
"""

import numpy as np
import torch

from delta_graph_slam_tpu.graph import SolverConfig as RConfig
from delta_graph_slam_tpu.graph import se3_graph as r_g
from delta_graph_slam_tpu.graph.se3_solver import optimize_se3 as r_optimize_se3
from delta_graph_slam_tpu_torch.graph import SolverConfig, optimize_se3
from delta_graph_slam_tpu_torch.interop import se3_builder_from_reference

from test_torch_se3 import plane_loop_graph

torch.set_num_threads(2)


def test_optimize_se3_chain_segments_matches_reference():
    """12 poses, one plane hub with 12 se3plane edges, one Huber loop,
    chain_segments=4 in both packages' chain backends."""
    ref = plane_loop_graph(r_g.SE3GraphBuilder, 12, priors=False)
    port = se3_builder_from_reference(ref)
    (wp, wpl, _), ws = r_optimize_se3(ref.to_arrays(), level=0,
                                      config=RConfig(backend="chain", chain_segments=4))
    g = port.to_arrays()
    (gp, gpl, _), gs = optimize_se3(g, level=0,
                                    config=SolverConfig(backend="chain", chain_segments=4))
    (gp0, gpl0, _), gs0 = optimize_se3(g, level=0, config=SolverConfig(backend="chain"))
    # the field changes nothing in the port: the same solve, bit for bit
    assert torch.equal(gp, gp0) and torch.equal(gpl, gpl0)
    assert gs.iterations == gs0.iterations and int(gs.n_offchain_dropped) == 0
    np.testing.assert_allclose(float(gs.chi2_initial), float(ws.chi2_initial), rtol=1e-9)
    chi2_g, chi2_w = float(gs.chi2_final), float(ws.chi2_final)
    # chi2 within 1e-4 relative or both under 1e-10; poses and the plane
    # within 1e-5 (the float64 hub solve against the double-float one)
    assert (abs(chi2_g - chi2_w) <= 1e-4 * chi2_w) or max(chi2_g, chi2_w) < 1e-10, (
        chi2_g, chi2_w)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gpl.numpy(), np.asarray(wpl), rtol=0, atol=1e-5)
