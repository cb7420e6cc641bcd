"""delta_graph_slam_tpu_torch - the PyTorch and CUDA port of delta_graph_slam_tpu.

Same sub-package layout and file names as the JAX package, which stays the
reference. This package imports torch and numpy, never jax. It covers the
delta pipeline without buildings: prefiltering, FAST_GICP scan-matching
odometry, odometry-edge information matrices, GPS, loop closure and the
two-level SE2 graph solve (graph/), with the exact 1-NN as a hand-written
CUDA kernel for Hopper (csrc/nn1.cu).
"""
