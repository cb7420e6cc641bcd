"""Line segments, corner ("edge") features, and candidate transforms.

All 2-D, fixed-capacity, masked, with optional leading batch dimensions.
Mirrors the reference structures LineFeature / EdgeFeature
(line_based_scanmatcher.hpp:23-47) and the geometry of
edge_extraction/get_edges/align_edges/align_lines
(line_based_scanmatcher.cpp:459-767).
"""

import math
from typing import NamedTuple

import numpy as np
import torch

from ..geom.se2 import rot2
from ..ops.ransac import LineSegments

_BIG = 1e9


class EdgeFeatures(NamedTuple):
    """Corner features: intersection point + one endpoint per arm."""

    corner: torch.Tensor  # (..., E, 2)
    a: torch.Tensor       # (..., E, 2) arm endpoint on line 1
    b: torch.Tensor       # (..., E, 2) arm endpoint on line 2
    mask: torch.Tensor    # (..., E)


def make_lines(a, b, capacity=None, dtype=torch.float32, device="cpu") -> LineSegments:
    """LineSegments on ``device`` from (L,2) host endpoint arrays."""
    a = np.atleast_2d(np.asarray(a, np.float64))[:, :2]
    b = np.atleast_2d(np.asarray(b, np.float64))[:, :2]
    n = len(a)
    cap = capacity or max(n, 1)
    A = np.zeros((cap, 2))
    B = np.zeros((cap, 2))
    A[:n] = a
    B[:n] = b
    mask = np.zeros(cap, bool)
    mask[:n] = True
    z = torch.zeros(cap, dtype=dtype, device=device)
    return LineSegments(
        a=torch.as_tensor(A, dtype=dtype, device=device),
        b=torch.as_tensor(B, dtype=dtype, device=device),
        mean_error=z, std_sigma=z, max_error=z, min_error=z,
        mask=torch.as_tensor(mask, device=device),
    )


def apply_rt(R, t, p):
    """R p + t for points p (..., L, 2), R (..., 2, 2), t (..., 2), written
    out elementwise: an identity R with a zero t returns p exactly."""
    x, y = p[..., 0], p[..., 1]
    R = R[..., None, :, :]
    t = t[..., None, :]
    return torch.stack([R[..., 0, 0] * x + R[..., 0, 1] * y + t[..., 0],
                        R[..., 1, 0] * x + R[..., 1, 1] * y + t[..., 1]], -1)


def transform_lines(lines: LineSegments, T) -> LineSegments:
    """Apply a rigid transform; T (..., 3, 3) SE2 or (..., 4, 4) SE3 (xy
    part), a tensor or a host array, cast to the lines' dtype."""
    T = torch.as_tensor(T, dtype=lines.a.dtype, device=lines.a.device)
    R = T[..., :2, :2]
    t = T[..., :2, 3] if T.shape[-1] == 4 else T[..., :2, 2]
    return lines._replace(a=apply_rt(R, t, lines.a), b=apply_rt(R, t, lines.b))


def _norm(v):
    return torch.linalg.norm(v, dim=-1)


def _unit(v):
    return v / torch.clamp(_norm(v)[..., None], min=1e-12)


def lines_intersection(a1, b1, a2, b2):
    """Infinite-line intersection (batched); parallel -> (BIG, BIG).
    Mirrors lines_intersection (line_based_scanmatcher.cpp:473-500)."""
    A1 = b1[..., 1] - a1[..., 1]
    B1 = a1[..., 0] - b1[..., 0]
    C1 = A1 * a1[..., 0] + B1 * a1[..., 1]
    A2 = b2[..., 1] - a2[..., 1]
    B2 = a2[..., 0] - b2[..., 0]
    C2 = A2 * a2[..., 0] + B2 * a2[..., 1]
    det = A1 * B2 - A2 * B1
    ok = torch.abs(det) > 1e-12
    det_safe = torch.where(ok, det, 1.0)
    x = (B2 * C1 - B1 * C2) / det_safe
    y = (A1 * C2 - A2 * C1) / det_safe
    x = torch.where(ok, x, _BIG)
    y = torch.where(ok, y, _BIG)
    return torch.stack([x, y], -1), ok


def gather_lines(x, idx):
    """x[..., idx, :] for (..., L, 2) endpoints and an index of any shape
    that broadcasts against the batch dimensions (..., K)."""
    idx = idx.expand(x.shape[:-2] + idx.shape[-1:])
    return torch.take_along_dim(x, idx[..., None], dim=-2)


def edge_extraction(
    lines: LineSegments,
    only_angular_edges: bool = False,
    max_dist_angular_edge: float = 7.0,
    capacity: int = 256,
) -> EdgeFeatures:
    """All corner features from near-perpendicular line pairs.

    Vectorizes get_edges' four-case analysis (line_based_scanmatcher.cpp:
    502-682): for every unordered pair (i<j), in the row-major order of
    triu_indices, up to 4 candidate edges are emitted with masks; the nine
    candidate families are concatenated in a fixed order and compacted
    (stable, valid first) into ``capacity`` slots.
    """
    L = lines.a.shape[-2]
    ii, jj = torch.triu_indices(L, L, 1, device=lines.a.device)
    a1, b1 = lines.a[..., ii, :], lines.b[..., ii, :]
    a2, b2 = lines.a[..., jj, :], lines.b[..., jj, :]
    pair_ok = lines.mask[..., ii] & lines.mask[..., jj]

    d1 = _unit(a1 - b1)
    d2 = _unit(a2 - b2)
    cosine = (d1 * d2).sum(-1)
    pair_ok = pair_ok & (torch.abs(cosine) <= 0.5)

    corner, int_ok = lines_intersection(a1, b1, a2, b2)
    pair_ok = pair_ok & int_ok

    min_side = 1.0
    s1A, s1B = a1 - corner, b1 - corner
    s2A, s2B = a2 - corner, b2 - corner
    n1A, n1B = _norm(s1A), _norm(s1B)
    n2A, n2B = _norm(s2A), _norm(s2B)
    same1 = (n1A < 0.01) | (n1B < 0.01) | (_norm(_unit(s1A) - _unit(s1B)) < 1.0)
    same2 = (n2A < 0.01) | (n2B < 0.01) | (_norm(_unit(s2A) - _unit(s2B)) < 1.0)

    long1 = torch.where((n1A > n1B)[..., None], a1, b1)     # longest arm line1
    long2 = torch.where((n2A > n2B)[..., None], a2, b2)
    max1, min1 = torch.maximum(n1A, n1B), torch.minimum(n1A, n1B)
    max2, min2 = torch.maximum(n2A, n2B), torch.minimum(n2A, n2B)

    # CASE 1: both lines end at the corner -> 1 edge (longest arms)
    c1_ok = same1 & same2 & (max1 >= min_side) & (max2 >= min_side)
    if only_angular_edges:
        c1_ok = c1_ok & (min1 <= max_dist_angular_edge) & (min2 <= max_dist_angular_edge)
    e1 = (corner, long1, long2, c1_ok)

    # CASE 2: line1 ends at corner, line2 crosses -> up to 2 edges
    c2_base = same1 & ~same2 & (max1 >= min_side)
    if only_angular_edges:
        c2_base = c2_base & (min1 <= max_dist_angular_edge)
    e2a = (corner, long1, a2, c2_base & (n2A > min_side))
    e2b = (corner, long1, b2, c2_base & (n2B > min_side))

    # CASE 3: symmetric (line2 ends at corner, line1 crosses)
    c3_base = ~same1 & same2 & (max2 >= min_side)
    if only_angular_edges:
        c3_base = c3_base & (min2 <= max_dist_angular_edge)
    e3a = (corner, long2, a1, c3_base & (n1A > min_side))
    e3b = (corner, long2, b1, c3_base & (n1B > min_side))

    # CASE 4: both cross -> up to 4 edges (one per arm pair)
    c4 = ~same1 & ~same2
    e4aa = (corner, a1, a2, c4 & (n1A > min_side) & (n2A > min_side))
    e4ab = (corner, a1, b2, c4 & (n1A > min_side) & (n2B > min_side))
    e4ba = (corner, b1, a2, c4 & (n1B > min_side) & (n2A > min_side))
    e4bb = (corner, b1, b2, c4 & (n1B > min_side) & (n2B > min_side))

    cands = [e1, e2a, e2b, e3a, e3b, e4aa, e4ab, e4ba, e4bb]
    corners = torch.cat([c[0] for c in cands], -2)
    arms_a = torch.cat([c[1] for c in cands], -2)
    arms_b = torch.cat([c[2] for c in cands], -2)
    masks = torch.cat([c[3] & pair_ok for c in cands], -1)

    # compact to capacity
    order = torch.argsort((~masks).to(torch.uint8), dim=-1, stable=True)[..., :capacity]
    m = torch.take_along_dim(masks, order, dim=-1)
    keep = m[..., None]
    return EdgeFeatures(
        corner=torch.where(keep, gather_lines(corners, order), 0.0),
        a=torch.where(keep, gather_lines(arms_a, order), 0.0),
        b=torch.where(keep, gather_lines(arms_b, order), 0.0),
        mask=m,
    )


def _angle_between(A, B):
    """Signed angle from A to B (batched 2-D), (cpp:684-691)."""
    dot = A[..., 0] * B[..., 0] + A[..., 1] * B[..., 1]
    det = A[..., 0] * B[..., 1] - A[..., 1] * B[..., 0]
    return torch.atan2(det, dot)


def _rotate(R, v):
    """R v for (..., 2, 2) R and (..., 2) v."""
    return torch.stack([R[..., 0, 0] * v[..., 0] + R[..., 0, 1] * v[..., 1],
                        R[..., 1, 0] * v[..., 0] + R[..., 1, 1] * v[..., 1]], -1)


def align_edges(e1_corner, e1a, e1b, e2_corner, e2a, e2b):
    """Rigid transform aligning edge1 to edge2 (cpp:693-740), batched.

    Two candidate rotations map either arm of edge1 onto edge2's longest
    arm; the one leaving the smaller residual to the other arm wins.
    Returns (R (...,2,2), t (...,2)).
    """
    s1A = e1a - e1_corner
    s1B = e1b - e1_corner
    s2A = e2a - e2_corner
    s2B = e2b - e2_corner
    swap = (_norm(s2A) < _norm(s2B))[..., None]
    s2A, s2B = torch.where(swap, s2B, s2A), torch.where(swap, s2A, s2B)
    R1 = rot2(_angle_between(s1A, s2A))
    R2 = rot2(_angle_between(s1B, s2A))
    ang3 = _angle_between(_rotate(R1, s1B), s2B)
    ang4 = _angle_between(_rotate(R2, s1A), s2B)
    use1 = torch.abs(ang3) < torch.abs(ang4)
    R = torch.where(use1[..., None, None], R1, R2)
    t = e2_corner - _rotate(R, e1_corner)
    return R, t


def align_lines_pair(l1a, l1b, l2a, l2b):
    """Rotate line1 parallel to line2 and project its A endpoint onto
    line2's infinite line (cpp:742-767), batched. Returns (R, t)."""
    ang = _angle_between(l1a - l1b, l2a - l2b)
    ang = torch.where(ang > math.pi / 2, ang - math.pi, ang)
    ang = torch.where(ang < -math.pi / 2, ang + math.pi, ang)
    d = _unit(l2a - l2b)
    proj = l2a + d * ((l1a - l2a) * d).sum(-1, keepdim=True)
    R = rot2(ang)
    t = proj - _rotate(R, l1a)
    return R, t
