"""Pipeline presets mirroring the reference launch files.

One typed config tree carries the rosparam surface of the five launch
files: delta_graph_slam.launch (KITTI + buildings), hdl_graph_slam.launch
and its _400/_501/_imu variants.
"""

import dataclasses

from ..lines.align import LineScanmatcherConfig
from ..models.delta_backend import DeltaBackendConfig
from ..models.floor_detection import FloorDetectionConfig
from ..models.hdl_backend import HdlBackendConfig
from ..models.prefiltering import PrefilteringConfig
from ..models.scan_matching_odometry import OdometryConfig
from ..pipeline.information_matrix import InformationMatrixCalculator
from ..register.config import RegistrationConfig

@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    name: str
    prefiltering: PrefilteringConfig
    odometry: OdometryConfig
    floor: FloorDetectionConfig = None
    delta: DeltaBackendConfig = None
    hdl: HdlBackendConfig = None

    @property
    def backend(self):
        return self.delta if self.delta is not None else self.hdl


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


def _hdl_preset(name="hdl", **over) -> PipelineConfig:
    """hdl_graph_slam.launch family (upstream SE3 pipeline).

    Registration: every hdl launch file overrides the nodelet's NDT_OMP code
    default to FAST_GICP with the tuning of the delta launch
    (hdl_graph_slam_400.launch:59-68; "FAST_GICP(recommended)").
    """
    reg = RegistrationConfig(method="FAST_GICP", transformation_epsilon=0.1,
                             maximum_iterations=64,
                             max_correspondence_distance=2.0,
                             correspondence_randomness=20, resolution=1.0)
    floor = FloorDetectionConfig(
        sensor_height=over.pop("sensor_height", 2.0),
        height_clip_range=1.0, floor_pts_thresh=512,
        floor_normal_thresh=10.0, use_normal_filtering=True,
        normal_filter_thresh=20.0,
    )
    hdl = HdlBackendConfig(
        registration=reg,
        enable_floor=over.pop("enable_floor", True),
        # every hdl launch defaults enable_gps to FALSE
        # (hdl_graph_slam_400.launch:6); the GPS-dataset preset (hdl_501)
        # opts in. On a loop-free odometry chain the global modes have zero
        # stiffness, so even a weak absolute prior pins the trajectory's
        # shape to the (noisy) GPS track.
        enable_gps=over.pop("enable_gps", False),
        enable_imu_acceleration=over.pop("enable_imu_acceleration", False),
        enable_imu_orientation=over.pop("enable_imu_orientation", False),
        # launch values for when GPS is enabled (..._400.launch:124-125)
        gps_edge_stddev_xy=over.pop("gps_edge_stddev_xy", 20.0),
        gps_edge_stddev_z=over.pop("gps_edge_stddev_z", 5.0),
    )
    return PipelineConfig(
        name=name,
        prefiltering=PrefilteringConfig(
            # every hdl launch runs the RADIUS outlier filter (0.5 m / min 2;
            # e.g. hdl_graph_slam_400.launch:36-41)
            use_distance_filter=True,
            distance_near_thresh=over.pop("distance_near_thresh", 0.1),
            distance_far_thresh=100.0, downsample_method="VOXELGRID",
            downsample_resolution=0.1,
            outlier_removal_method=over.pop("outlier_removal_method",
                                            "RADIUS"),
            radius_radius=0.5, radius_min_neighbors=2,
        ),
        odometry=OdometryConfig(
            # the hdl launch files override the nodelet's 0.25/0.15/1.0 code
            # defaults (scan_matching_odometry_nodelet.cpp:73-75) to
            # 1.0/1.0/10000 (hdl_graph_slam_400.launch:49-51); the code
            # defaults swap the odometry keyframe EVERY frame at driving
            # speed, a full target-model rebuild per scan
            registration=reg, keyframe_delta_trans=1.0,
            keyframe_delta_angle=1.0, keyframe_delta_time=10000.0,
            transform_thresholding=False, downsample_method="NONE",
        ),
        floor=floor,
        hdl=hdl,
    )


PRESETS = {
    "delta": _delta_preset,
    "hdl": lambda: _hdl_preset("hdl"),
    # hdl_graph_slam_400.launch: outdoor HDL32e, floor constraint active
    "hdl_400": lambda: _hdl_preset("hdl_400", sensor_height=2.0),
    # hdl_graph_slam_501.launch: indoor + GPS/NMEA
    "hdl_501": lambda: _hdl_preset(
        "hdl_501", gps_edge_stddev_xy=20.0, enable_floor=True,
        enable_gps=True,            # the GPS/NMEA dataset preset
        distance_near_thresh=0.5,   # hdl_graph_slam_501.launch:31
    ),
    # hdl_graph_slam_imu.launch: gravity + orientation edges
    "hdl_imu": lambda: _hdl_preset(
        "hdl_imu", enable_imu_acceleration=True,
        enable_imu_orientation=True,
        distance_near_thresh=0.2,   # hdl_graph_slam_imu.launch:42
    ),
}


def get_preset(name: str) -> PipelineConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown preset {name!r}; known: {sorted(PRESETS)}")
    return PRESETS[name]()
