"""Pose-graph core: typed edge tables, robust kernels, level-masked LM.

SE2 half of the JAX package's graph/ (the SE3 graph, its solver and the
hub solve come with the hdl path). The chain backend's elimination runs in
native float64 (chain_solve.py).
"""

from .robust import ROBUST_KERNELS, robust_rho, robust_weight, kernel_id
from .se2_graph import (
    SE2Edges,
    SE2PriorXYEdges,
    SE2PriorYawEdges,
    SE2Graph,
    SE2GraphBuilder,
)
from .solver import optimize_se2, SolverConfig, SolverStats
from .graph_io import save_g2o, load_g2o, save_npz, load_npz

__all__ = [
    "ROBUST_KERNELS", "robust_rho", "robust_weight", "kernel_id",
    "SE2Edges", "SE2PriorXYEdges", "SE2PriorYawEdges", "SE2Graph",
    "SE2GraphBuilder", "optimize_se2", "SolverConfig", "SolverStats",
    "save_g2o", "load_g2o", "save_npz", "load_npz",
]
