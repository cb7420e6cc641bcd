"""Keyframe payload records.

Mirrors the reference KeyFrame/KeyFrameSnapshot (keyframe.hpp:46-58,
keyframe.cpp:32-36): stamp, 3-D odometry, flattened SE2 odometry,
accumulated travel distance, 3-D cloud, 2-D flattened cloud, the map-frame
estimate, the building-alignment results, optional GPS and ground-truth
poses, and the pose-graph vertex id.
"""

import dataclasses
from typing import Any, Optional

import numpy as np


@dataclasses.dataclass
class KeyFrame:
    stamp: float
    odom: np.ndarray                 # (4,4) raw 3-D odometry
    odom2d: np.ndarray               # (3,) [x,y,theta]
    accum_distance: float
    cloud: Any                       # MaskedCloud (3-D)
    flat_cloud: Any                  # MaskedCloud (2-D flattened)
    node_id: Optional[int] = None    # pose-graph vertex
    estimated_odom: Optional[np.ndarray] = None  # (3,) after building align
    global_alignment: Any = None     # building alignment result (slice 3)
    near_buildings: Any = None       # buildings in range at admission
    gps_coord: Optional[np.ndarray] = None       # (2,) ENU of the matched fix
    gt_pose: Optional[np.ndarray] = None         # (3,) ground truth SE2

    def estimate(self, poses):
        """Current optimized pose from the graph pose table."""
        return np.asarray(poses[self.node_id])


@dataclasses.dataclass
class KeyFrameSnapshot:
    """Snapshot for map generation (keyframe.cpp:32-36)."""
    pose: np.ndarray                 # (3,) optimized SE2 pose
    cloud: Any                       # MaskedCloud (the 3-D cloud)
    flat_cloud: Any = None
