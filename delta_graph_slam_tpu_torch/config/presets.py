"""Pipeline presets mirroring the reference launch files.

The ``delta`` preset carries the launch values of delta_graph_slam.launch
(KITTI + buildings); the hdl presets raise until the SE3 path is ported.
"""

import dataclasses

from ..lines.align import LineScanmatcherConfig
from ..models.delta_backend import DeltaBackendConfig
from ..models.prefiltering import PrefilteringConfig
from ..models.scan_matching_odometry import OdometryConfig
from ..pipeline.information_matrix import InformationMatrixCalculator
from ..register.config import RegistrationConfig

HDL_PRESETS = ("hdl", "hdl_400", "hdl_501", "hdl_imu")


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    name: str
    prefiltering: PrefilteringConfig
    odometry: OdometryConfig
    delta: DeltaBackendConfig


def _delta_preset() -> PipelineConfig:
    """delta_graph_slam.launch (KITTI 0027 + OSM buildings)."""
    reg_front = RegistrationConfig(           # launch :59-69
        method="FAST_GICP", transformation_epsilon=0.1,
        maximum_iterations=64, max_correspondence_distance=2.0,
        correspondence_randomness=20, resolution=1.0,
    )
    return PipelineConfig(
        name="delta",
        prefiltering=PrefilteringConfig(      # launch :30-42
            use_distance_filter=True, distance_near_thresh=0.1,
            distance_far_thresh=100.0, downsample_method="VOXELGRID",
            downsample_resolution=0.1, outlier_removal_method="RADIUS",
            radius_radius=0.5, radius_min_neighbors=2,
        ),
        odometry=OdometryConfig(              # launch :47-69
            registration=reg_front,
            keyframe_delta_trans=1.0, keyframe_delta_angle=1.0,
            keyframe_delta_time=10000.0, transform_thresholding=False,
            max_acceptable_trans=1.0, max_acceptable_angle=1.0,
            downsample_method="NONE",
        ),
        delta=DeltaBackendConfig(             # launch :74-170
            max_keyframes_per_update=10, keyframe_delta_trans=2.0,
            keyframe_delta_angle=2.0, fix_first_node=True,
            g2o_solver_num_iterations=512, graph_update_interval=3.0,
            distance_thresh=15.0, accum_distance_thresh=25.0,
            min_edge_interval=15.0, fitness_score_thresh=2.5,
            gps_edge_stddev_xy=1500.0,
            loop_closure_edge_robust_kernel="Huber",
            loop_closure_edge_robust_kernel_size=1.0,
            nearby_buildings_radius=35.0, buffer_buildings_radius=120.0,
            registration=reg_front,
            scanmatcher=LineScanmatcherConfig(   # launch :149-170
                min_cluster_size=40, max_cluster_size=25000,
                cluster_tolerance=1.5, sac_distance_threshold=0.1,
                max_iterations=100, merror_threshold=0.1,
                line_length_threshold=1.5,
                g_avg_distance_weight=1.5, g_coverage_weight=0.5,
                g_transform_weight=0.5, g_max_score_distance=3.5,
                g_max_score_translation=3.5,
                l_avg_distance_weight=1.5, l_coverage_weight=1.5,
                l_transform_weight=0.1, l_max_score_distance=1.0,
                l_max_score_translation=3.5,
            ),
            inf=InformationMatrixCalculator(     # launch :116-141
                use_const_inf_matrix=False, const_stddev_x=0.5,
                const_stddev_q=0.1, var_gain_a=20.0, min_stddev_x=0.1,
                max_stddev_x=5.0, min_stddev_q=0.05, max_stddev_q=0.2,
                fitness_score_thresh=0.5,
                b_var_gain_a=7.0, b_min_stddev_x=0.1, b_max_stddev_x=2.0,
                b_min_stddev_q=0.05, b_max_stddev_q=0.2,
                b_avg_fitness_score=1.75,
                b_importance_ratio_global=500.0,
                b_importance_ratio_local=25.0,
            ),
        ),
    )


PRESETS = {"delta": _delta_preset}


def get_preset(name: str) -> PipelineConfig:
    if name in HDL_PRESETS:
        raise NotImplementedError(f"preset {name!r}: the hdl SE3 path is not ported")
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; known: {sorted(PRESETS)}")
    return PRESETS[name]()
