"""Loop-closure detection: host-side candidate gating + scan-match
validation on the device.

Gating reproduces LoopDetector::find_candidates (loop_detector.hpp:83-111):
the new keyframe must be >= min_edge_interval of travel past the last loop
edge; a candidate must be >= accum_distance_thresh of travel away AND
<= distance_thresh away in current estimated 2-D position.

Validation (loop_detector.hpp:119-173) registers each candidate's cloud
onto the new keyframe's cloud with the shared registration engine and
scores it with information_matrix.fitness_score (the 1-NN kernel on the
card), keeping the best score below fitness_score_thresh.
"""

import dataclasses
from typing import List, Optional

import numpy as np

from ..geom.host import (
    se2_compose_np, se2_inverse_np, transform_2d_to_3d_np,
    transform_3d_to_2d_np,
)
from .information_matrix import fitness_score
from .keyframe import KeyFrame


@dataclasses.dataclass
class Loop:
    key1: KeyFrame          # loop end (new keyframe)
    key2: KeyFrame          # loop begin (old keyframe)
    relative_pose: np.ndarray    # (4,4) 3-D registration result
    relpose_2d: np.ndarray       # (3,) flattened


class LoopDetector:
    def __init__(self, registration, distance_thresh=5.0,
                 accum_distance_thresh=8.0, min_edge_interval=5.0,
                 fitness_score_max_range=float("inf"),
                 fitness_score_thresh=0.5):
        self.registration = registration
        self.distance_thresh = distance_thresh
        self.accum_distance_thresh = accum_distance_thresh
        self.distance_from_last_edge_thresh = min_edge_interval
        self.fitness_score_max_range = fitness_score_max_range
        self.fitness_score_thresh = fitness_score_thresh
        self.last_edge_accum_distance = 0.0

    def detect(self, keyframes, new_keyframes, poses) -> List[Loop]:
        """poses: current optimized (V,3) SE2 pose table."""
        loops = []
        for nk in new_keyframes:
            loop = self.matching(self.find_candidates(keyframes, nk, poses),
                                 nk, poses)
            if loop is not None:
                loops.append(loop)
        return loops

    def find_candidates(self, keyframes, new_keyframe, poses):
        if (new_keyframe.accum_distance - self.last_edge_accum_distance
                < self.distance_from_last_edge_thresh):
            return []
        out = []
        pos2 = new_keyframe.estimate(poses)[:2]
        for k in keyframes:
            if (new_keyframe.accum_distance - k.accum_distance
                    < self.accum_distance_thresh):
                continue
            if np.linalg.norm(k.estimate(poses)[:2] - pos2) > self.distance_thresh:
                continue
            out.append(k)
        return out

    def matching(self, candidates, new_keyframe, poses) -> Optional[Loop]:
        if not candidates:
            return None
        # target = new keyframe cloud (loop_detector.hpp:125)
        target = self.registration.build_target(new_keyframe.cloud)
        best_score = float("inf")
        best: Optional[KeyFrame] = None
        best_T = None
        nk_est = new_keyframe.estimate(poses)
        for cand in candidates:
            guess = transform_2d_to_3d_np(
                se2_compose_np(se2_inverse_np(nk_est), cand.estimate(poses)))
            src = self.registration.build_source(cand.cloud)
            res = self.registration._align(src, target, guess)
            T = res.transformation.cpu().numpy()
            score = fitness_score(new_keyframe.cloud, cand.cloud, T,
                                  self.fitness_score_max_range)
            if not bool(res.converged) or score > best_score:
                continue
            best_score, best, best_T = score, cand, T
        if best is None or best_score > self.fitness_score_thresh:
            return None
        self.last_edge_accum_distance = new_keyframe.accum_distance
        return Loop(key1=new_keyframe, key2=best, relative_pose=best_T,
                    relpose_2d=transform_3d_to_2d_np(best_T))
