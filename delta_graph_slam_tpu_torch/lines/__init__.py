"""Line-feature scan matching against building outlines (PyTorch port).

The reference LineBasedScanmatcher (line_based_scanmatcher.cpp) on
fixed-capacity masked tensors: corner ("edge") extraction is a dense
pairwise tensor op, and the greedy best-so-far candidate loops become
chunked score-everything + first argmax.
"""

from .features import (
    LineSegments,
    EdgeFeatures,
    make_lines,
    transform_lines,
    edge_extraction,
    align_edges,
    align_lines_pair,
)
from .scoring import (
    FitnessScore,
    line_to_line_distance,
    calc_fitness_score,
    nearest_neighbor,
    weight_score,
)
from .align import (
    LineScanmatcherConfig,
    BestFitAlignment,
    LineBasedScanmatcher,
)
from .merge import merge_lines, are_lines_aligned
from .overlap import are_buildings_overlapped, segments_intersect

__all__ = [
    "LineSegments", "EdgeFeatures", "make_lines", "transform_lines",
    "edge_extraction", "align_edges", "align_lines_pair",
    "FitnessScore", "line_to_line_distance", "calc_fitness_score",
    "nearest_neighbor", "weight_score",
    "LineScanmatcherConfig", "BestFitAlignment", "LineBasedScanmatcher",
    "merge_lines", "are_lines_aligned",
    "are_buildings_overlapped", "segments_intersect",
]
