"""Polygon overlap test between buildings.

Vectorizes check_overlapping.hpp: shrink both outlines 1% toward their
centers (:51-70), then declare overlap iff any pair of segments
intersects, where "intersects" means the infinite-line intersection point
falls strictly inside both segments' bounding intervals (:10-49).
"""

from .features import lines_intersection

SHRINK_RATIO = 0.99


def _point_in_segment_box(p, a, b):
    """check_overlapping.hpp:10-22 — (x<x1) != (x<x2) || (y<y1) != (y<y2)."""
    x, y = p[..., 0], p[..., 1]
    xin = (x < a[..., 0]) != (x < b[..., 0])
    yin = (y < a[..., 1]) != (y < b[..., 1])
    return xin | yin


def segments_intersect(a1, b1, a2, b2):
    """Batched segment intersection with the reference's semantics."""
    p, ok = lines_intersection(a1, b1, a2, b2)
    return ok & _point_in_segment_box(p, a1, b1) & _point_in_segment_box(p, a2, b2)


def shrink_polygon(a, b, center, ratio=SHRINK_RATIO):
    """Scale segment endpoints toward center (broadcasts)."""
    return center + ratio * (a - center), center + ratio * (b - center)


def are_buildings_overlapped(a_a, a_b, a_mask, center_a, b_a, b_b, b_mask, center_b):
    """True iff any shrunken segment of A intersects any of B.

    a_a/a_b: (...,La,2); b_a/b_b: (...,Lb,2); centers (...,2).
    Batch dims broadcast (e.g. candidate transforms on A).
    """
    sa_a, sa_b = shrink_polygon(a_a, a_b, center_a[..., None, :])
    sb_a, sb_b = shrink_polygon(b_a, b_b, center_b[..., None, :])
    inter = segments_intersect(
        sa_a[..., :, None, :], sa_b[..., :, None, :],
        sb_a[..., None, :, :], sb_b[..., None, :, :],
    )
    valid = a_mask[..., :, None] & b_mask[..., None, :]
    return (inter & valid).any(-1).any(-1)
