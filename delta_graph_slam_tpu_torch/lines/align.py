"""Line-feature scan matcher (align_global / align_local /
align_overlapped_buildings, line_based_scanmatcher.cpp), configuration.

The matcher itself is slice 3 of the port. The delta backend's config
already carries its settings (the launch file's values), stored and not
read yet, so configs of the two packages carry across.
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class LineScanmatcherConfig:
    # line fitting (hpp:80-92 defaults; delta launch overrides)
    min_cluster_size: int = 25
    max_cluster_size: int = 25000
    cluster_tolerance: float = 1.0
    sac_distance_threshold: float = 0.1
    max_iterations: int = 500
    merror_threshold: float = 150.0
    line_length_threshold: float = 1.0
    # global fitness weights (hpp:93-99)
    g_avg_distance_weight: float = 0.6
    g_coverage_weight: float = 1.0
    g_transform_weight: float = 0.2
    g_max_score_distance: float = 5.0
    g_max_score_translation: float = 5.0
    # local fitness weights
    l_avg_distance_weight: float = 0.6
    l_coverage_weight: float = 1.0
    l_transform_weight: float = 0.2
    l_max_score_distance: float = 5.0
    l_max_score_translation: float = 5.0
    # capacities
    max_lines: int = 24
    max_target_lines: int = 64
    edge_capacity: int = 128
    target_edge_capacity: int = 192
    # edge capacity of the building side of align_local / align_overlapped
    # (building polygons carry <= ~16 outline lines)
    building_edge_capacity: int = 32
    # phase-1 candidates are compacted (stable, valid-first) to this many
    # slots before scoring; overflow drops later-index candidates only
    g_candidate_capacity: int = 4096
    l_candidate_capacity: int = 1024
    score_chunk: int = 256
    n_hypotheses: int = 256
    cloud_chunk: int = 1024
