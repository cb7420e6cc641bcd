"""Keyframe admission policy.

Exact semantics of the reference KeyframeUpdater
(keyframe_updater.hpp:34-55): register a frame when either delta
translation >= keyframe_delta_trans or delta angle >= keyframe_delta_angle
vs the previous keypose; accumulate travel distance over registered
keyframes.
"""

import numpy as np

from ..geom.host import normalize_angle_np


class KeyframeUpdater:
    def __init__(self, keyframe_delta_trans=2.0, keyframe_delta_angle=2.0):
        self.keyframe_delta_trans = keyframe_delta_trans
        self.keyframe_delta_angle = keyframe_delta_angle
        self.is_first = True
        self.prev_keypose = np.zeros(3)
        self.accum_distance = 0.0

    def update(self, pose) -> bool:
        """pose: (3,) SE2 params. True if the frame should become a keyframe."""
        pose = np.asarray(pose, float)
        if self.is_first:
            self.is_first = False
            self.prev_keypose = pose
            return True
        dxy = pose[:2] - self.prev_keypose[:2]
        dx = float(np.linalg.norm(dxy))
        da = abs(float(normalize_angle_np(pose[2] - self.prev_keypose[2])))
        if dx < self.keyframe_delta_trans and da < self.keyframe_delta_angle:
            return False
        self.accum_distance += dx
        self.prev_keypose = pose
        return True

    def get_accum_distance(self) -> float:
        return self.accum_distance
