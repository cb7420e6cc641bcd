"""Registration method configuration.

Mirrors the parameter surface of select_registration_method
(registrations.cpp:22-124): the same
method strings and rosparam names map onto one engine with different cost
heads. OpenMP thread counts are accepted and ignored.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class RegistrationConfig:
    # method: ICP | GICP | GICP_OMP | FAST_GICP | FAST_VGICP | NDT | NDT_OMP
    method: str = "NDT_OMP"
    resolution: float = 0.5              # reg_resolution (NDT/VGICP voxel size)
    transformation_epsilon: float = 0.01  # reg_transformation_epsilon
    maximum_iterations: int = 64          # reg_maximum_iterations
    max_correspondence_distance: float = 2.5  # reg_max_correspondence_distance
    correspondence_randomness: int = 20   # reg_correspondence_randomness (cov kNN)
    nn_search_method: str = "DIRECT7"     # reg_nn_search_method (NDT_OMP)
    use_reciprocal_correspondences: bool = False  # accepted, not implemented
    num_threads: int = 0                  # accepted, ignored
    max_optimizer_iterations: int = 20    # accepted (GICP inner loop)
    # engine knobs (no reference analogue)
    lm_lambda: float = 1e-6               # tiny LM damping for GN robustness
    chunk: int = 2048                     # NN tile size (brute path)
    ndt_outlier_ratio: float = 0.55       # PCL NDT outlier mixture weight
    # correspondence search: 'voxel' bounds candidates to the 27-cell
    # neighborhood of a spatial hash (fast, coverage radius ~ resolution);
    # 'brute' is the exact tiled search (kd-tree-equivalent quality)
    nn_method: str = "voxel"
    nn_voxel_resolution: float = 1.0
    nn_voxel_window: int = 8              # candidate points kept per cell
    nn_voxel_cells: int = 7               # candidate cells (7 or 27); gathers
                                          # scale with cells*window
    cov_voxel_window: int = 8             # candidates per cell for kNN covs
    cov_voxel_cells: int = 7
    # GICP covariance neighborhoods: 'knn' is fast_gicp's k-NN (k =
    # correspondence_randomness); 'dense' computes the exact
    # radius-neighborhood covariance via the masked-moments matmul pass
    # (ops/moments.py; DIVERGENCES.md #12), not ported yet.
    # 'auto' resolves to 'knn' in this package.
    cov_method: str = "auto"
    cov_dense_radius: float = 1.0
    # Reuse correspondences for this many GN iterations before re-running
    # the candidate search (fast_gicp-style): the voxel-window NN scan is
    # the dominant per-iteration cost at 32k points, while the distance
    # gates are still re-evaluated at the current transform every
    # iteration. 1 = search every iteration (reference semantics).
    nn_reuse: int = 1

    @property
    def head(self) -> str:
        m = self.method.upper()
        if "VGICP" in m:
            return "vgicp"
        if "GICP" in m:
            return "gicp"
        if "NDT" in m:
            return "ndt"
        if m == "ICP":
            return "icp"
        # reference falls back to NDT for unknown strings (registrations.cpp:95-98)
        return "ndt"

    @property
    def neighbor_offsets(self) -> int:
        """Number of voxel neighbors searched (1, 7 or 27).

        VGICP uses fast_vgicp's DIRECT27 default: every found neighbor
        voxel contributes a distribution residual (this carries a small
        voxel-quantization equilibrium bias, O(resolution/20), exactly as
        the original). NDT uses DIRECT7/DIRECT1 with Magnusson's
        exponential weight saturating far neighbor pulls (see engine.py).
        """
        if self.head == "vgicp":
            return 27
        if self.head == "ndt":
            if self.nn_search_method.upper() == "DIRECT1":
                return 1
            return 7  # DIRECT7 default; KDTREE approximated by DIRECT7
        return 1


# Launch-file presets (delta uses FAST_GICP; upstream hdl launches use NDT_OMP,
# see delta_graph_slam.launch:59-69)
REGISTRATION_PRESETS = {
    "delta": RegistrationConfig(method="FAST_GICP", resolution=1.0),
    "hdl": RegistrationConfig(method="NDT_OMP", resolution=1.0, nn_search_method="DIRECT7"),
}
