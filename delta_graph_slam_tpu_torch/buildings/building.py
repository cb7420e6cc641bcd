"""Building entity: OSM footprint + pose-graph vertex.

Mirrors Building (building.cpp): the stored outline (corners, lines,
interpolated cloud) is in map coordinates at download time; getters
re-pose it by the current graph estimate with a rotation about the
building center (building.cpp:7-61). The outline lines and cloud live on
the backend's device, the corners on the host.
"""

import dataclasses
from typing import Any, Optional

import numpy as np
import torch

from ..ops.cloud import MaskedCloud


def building_map_transform(pose, estimate):
    """(3,3) map-frame transform for a building.

    pose: (3,) the fixed OSM pose (yaw 0, translation = bbox center);
    estimate: (3,) current graph estimate. The reference computes
    trans = pose^-1 * estimate then re-centers the rotation on the
    building translation (building.cpp:10-13).
    """
    pose = np.asarray(pose, float)
    est = np.asarray(estimate, float)
    # delta = pose^-1 * estimate: translation t_e - t_p (pose rotation is 0),
    # rotation = theta_e - theta_p (theta_p = 0)
    th = est[2] - pose[2]
    c, s = np.cos(th), np.sin(th)
    R = np.array([[c, -s], [s, c]])
    t = est[:2] - pose[:2]
    # re-center rotation about the building translation
    t = t + pose[:2] - R @ pose[:2]
    out = np.eye(3)
    out[:2, :2] = R
    out[:2, 2] = t
    return out


@dataclasses.dataclass
class Building:
    id: str
    pose: np.ndarray                    # (3,) SE2, yaw = 0 (OSM prior)
    corners: np.ndarray                 # (P,2) polygon nodes in map frame
    lines: Any                          # LineSegments (raw outline)
    cloud: MaskedCloud                  # interpolated 2 cm outline points
    node_id: Optional[int] = None       # pose-graph vertex id
    prior_edge_ids: tuple = ()

    def estimate(self, poses) -> np.ndarray:
        if self.node_id is None:
            return np.asarray(self.pose)
        return np.asarray(poses[self.node_id])

    def _trans(self, poses, like):
        T = building_map_transform(self.pose, self.estimate(poses))
        T = torch.as_tensor(T, dtype=like.dtype, device=like.device)
        return T[:2, :2], T[:2, 2]

    def get_lines(self, poses):
        R, t = self._trans(poses, self.lines.a)
        return self.lines._replace(a=self.lines.a @ R.T + t, b=self.lines.b @ R.T + t)

    def get_cloud(self, poses) -> MaskedCloud:
        R, t = self._trans(poses, self.cloud.points)
        xy = self.cloud.points[:, :2] @ R.T + t
        return MaskedCloud(torch.cat([xy, self.cloud.points[:, 2:]], 1), self.cloud.mask)

    def get_points(self, poses) -> np.ndarray:
        T = building_map_transform(self.pose, self.estimate(poses))
        return self.corners @ T[:2, :2].T + T[:2, 2]
