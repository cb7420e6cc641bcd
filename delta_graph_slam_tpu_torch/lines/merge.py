"""Collinear line merging (host-side, exact reference semantics).

A copy of delta_graph_slam_tpu/lines/merge.py: numpy on the host.

merge_lines (line_based_scanmatcher.cpp:1076-1103) is a sequential greedy
merge with restart: whenever two lines are near-collinear (|cos| >= 0.9995)
with matching endpoints (< 0.3 m gap) and not overlapped, they fuse into
one longer line and the scan restarts at the fused line. Building outlines
have tens of lines, so this runs on the host in numpy; the result feeds
the alignment on the device.
"""

import numpy as np

_COS_THRESH = 0.9995
_GAP = 0.3


def _unit(v):
    n = np.linalg.norm(v)
    return v / max(n, 1e-12)


def _is_point_on_line(p, a, b):
    dot1 = np.dot(p - a, b - a)
    dot2 = np.dot(p - b, a - b)
    return dot1 >= 0 and dot2 >= 0


def are_lines_aligned(a1, b1, a2, b2):
    """Return merged (a, b) or None (cpp:1012-1074)."""
    c = abs(np.dot(_unit(a1 - b1), _unit(a2 - b2)))
    if c < _COS_THRESH:
        return None
    # identical lines
    if (
        (np.linalg.norm(a1 - a2) < _GAP and np.linalg.norm(b1 - b2) < _GAP)
        or (np.linalg.norm(a1 - b2) < _GAP and np.linalg.norm(b1 - a2) < _GAP)
    ):
        return (a1, b1)
    if np.linalg.norm(a1 - a2) < _GAP:
        if _is_point_on_line(b1, a2, b2) or _is_point_on_line(b2, a1, b1):
            return None
        return (b1, b2)
    if np.linalg.norm(a1 - b2) < _GAP:
        if _is_point_on_line(b1, a2, b2) or _is_point_on_line(a2, a1, b1):
            return None
        return (b1, a2)
    if np.linalg.norm(b1 - a2) < _GAP:
        if _is_point_on_line(a1, a2, b2) or _is_point_on_line(b2, a1, b1):
            return None
        return (a1, b2)
    if np.linalg.norm(b1 - b2) < _GAP:
        if _is_point_on_line(a1, a2, b2) or _is_point_on_line(a2, a1, b1):
            return None
        return (a1, a2)
    return None


def merge_lines(endpoints_a, endpoints_b):
    """endpoints (L,2) arrays -> merged (list_a, list_b) numpy arrays."""
    lines = [
        (np.asarray(a, float), np.asarray(b, float))
        for a, b in zip(endpoints_a, endpoints_b)
    ]
    i = 0
    while i < len(lines):
        merged_any = False
        for j in range(i + 1, len(lines)):
            m = are_lines_aligned(lines[i][0], lines[i][1], lines[j][0], lines[j][1])
            if m is not None:
                del lines[j]
                lines[i] = m
                merged_any = True
                break
        if merged_any:
            # reference restarts at the same index (i-- then i++)
            continue
        i += 1
    if not lines:
        return np.zeros((0, 2)), np.zeros((0, 2))
    return (
        np.stack([l[0] for l in lines]),
        np.stack([l[1] for l in lines]),
    )
