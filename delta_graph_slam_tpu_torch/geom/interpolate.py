"""Segment -> point-cloud interpolation (fixed-capacity, masked).

Reference: interpolate() emits one point every 2 cm from a to b inclusive of
the start and of every step <= |b-a| (ros_utils.cpp:146-165). Batched and
fixed-shape: ``capacity`` points per segment with a validity mask.
"""

import torch

SAMPLE_STEP = 0.02  # meters, matches the reference's 2 cm


def interpolate_segment(a, b, capacity, step=SAMPLE_STEP):
    """Sample points along segments a->b every ``step`` meters.

    a, b: (..., 2 or 3) tensors. Returns (points (..., capacity, d), mask
    (..., capacity)). Point i = a + i*step*normalize(b-a) for i*step <= |b-a|
    (z forced to 0 when d == 3: the reference flattens buildings to the
    plane).
    """
    ab = b - a
    norm = torch.linalg.norm(ab, dim=-1, keepdim=True)
    direction = ab / torch.clamp(norm, min=1e-12)
    offs = (torch.arange(capacity, dtype=a.dtype, device=a.device)
            * torch.tensor(step, dtype=a.dtype, device=a.device))
    pts = a[..., None, :] + offs[:, None] * direction[..., None, :]
    mask = offs <= norm  # broadcast (..., capacity)
    if a.shape[-1] == 3:
        pts[..., 2] = 0.0
    pts = torch.where(mask[..., None], pts, 0.0)
    return pts, mask
