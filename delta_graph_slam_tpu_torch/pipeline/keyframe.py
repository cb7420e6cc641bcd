"""Keyframe payload record.

Mirrors the reference KeyFrame (keyframe.hpp:46-58): stamp, 3-D odometry,
flattened SE2 odometry, accumulated travel distance, 3-D cloud, 2-D
flattened cloud, the map-frame estimate, the optional ground-truth pose
and the pose-graph vertex id. The building and GPS fields come with
their ports.
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
    gt_pose: Optional[np.ndarray] = None         # (3,) ground truth SE2
