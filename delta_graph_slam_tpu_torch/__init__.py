"""delta_graph_slam_tpu_torch - the PyTorch and CUDA port of delta_graph_slam_tpu.

Same sub-package layout and file names as the JAX package, which stays the
reference. This package imports torch and numpy, never jax. The first
slice covers the delta front end: prefiltering, FAST_GICP scan-matching
odometry and the odometry-edge information matrices, with the exact 1-NN
as a hand-written CUDA kernel for Hopper (csrc/nn1.cu).
"""
