"""Static transform table (tf-lite).

A copy of the JAX package's io/tf_table.py (host numpy). Replaces the
reference's tf lookups (base_link reframing prefiltering_nodelet.cpp:123-150,
ground-truth harvesting delta_graph_slam_nodelet.cpp:172-195,
retrieve_transform ros_utils.cpp:196-221) with an explicit frame graph of
static transforms plus optional time-stamped dynamic frames.
"""

import bisect
from typing import Dict, List, Tuple

import numpy as np


class TransformTable:
    def __init__(self):
        self._static: Dict[Tuple[str, str], np.ndarray] = {}
        self._dynamic: Dict[Tuple[str, str], List[Tuple[float, np.ndarray]]] = {}

    def set_static(self, target: str, source: str, T):
        T = np.asarray(T, float).reshape(4, 4)
        self._static[(target, source)] = T
        self._static[(source, target)] = np.linalg.inv(T)

    def add_dynamic(self, target: str, source: str, stamp: float, T):
        key = (target, source)
        self._dynamic.setdefault(key, []).append(
            (float(stamp), np.asarray(T, float).reshape(4, 4))
        )

    def lookup(self, target: str, source: str, stamp: float = 0.0) -> np.ndarray:
        if target == source:
            return np.eye(4)
        if (target, source) in self._static:
            return self._static[(target, source)]
        key = (target, source)
        if key in self._dynamic:
            seq = self._dynamic[key]
            stamps = [s for s, _ in seq]
            i = bisect.bisect_left(stamps, stamp)
            i = min(max(i, 0), len(seq) - 1)
            # nearest of i-1/i
            if i > 0 and abs(seq[i - 1][0] - stamp) < abs(seq[i][0] - stamp):
                i -= 1
            return seq[i][1]
        inv = (source, target)
        if inv in self._dynamic:
            return np.linalg.inv(self.lookup(source, target, stamp))
        raise KeyError(f"no transform {source} -> {target}")

    def can_transform(self, target: str, source: str) -> bool:
        return (
            target == source
            or (target, source) in self._static
            or (target, source) in self._dynamic
            or (source, target) in self._dynamic
        )
