"""Pose-graph core: typed edge tables, robust kernels, level-masked LM.

The SE2 graph of the delta backend and the SE3 graph (poses, planes,
points) of the hdl backend, on one LM core. The chain backend's elimination
runs in native float64 (chain_solve.py, hub_solve.py).
"""

from .robust import ROBUST_KERNELS, robust_rho, robust_weight, kernel_id
from .se2_graph import (
    SE2Edges,
    SE2PriorXYEdges,
    SE2PriorYawEdges,
    SE2Graph,
    SE2GraphBuilder,
)
from .se3_graph import SE3Graph, SE3GraphBuilder
from .solver import optimize_se2, SolverConfig, SolverStats
from .se3_solver import optimize_se3
from .graph_io import (
    save_g2o, load_g2o, save_npz, load_npz, save_g2o_se3, load_g2o_se3,
)

__all__ = [
    "ROBUST_KERNELS", "robust_rho", "robust_weight", "kernel_id",
    "SE2Edges", "SE2PriorXYEdges", "SE2PriorYawEdges", "SE2Graph",
    "SE2GraphBuilder", "SE3Graph", "SE3GraphBuilder", "optimize_se2",
    "optimize_se3", "SolverConfig", "SolverStats",
    "save_g2o", "load_g2o", "save_npz", "load_npz", "save_g2o_se3",
    "load_g2o_se3",
]
