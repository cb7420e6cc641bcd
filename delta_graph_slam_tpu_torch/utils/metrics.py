"""Trajectory quality metrics (ATE / RPE) over SE2 keyframe estimates.

The reference prints ATE / translational-RPE / rotational-RPE means and
stds at save_map time as its quality bottom line
(delta_graph_slam_nodelet.cpp:1204-1280).
"""

import numpy as np

from ..geom.host import se2_compose_np, se2_inverse_np


def ate_rpe_se2(ests, gts):
    """ests/gts: sequences of (3,) SE2 poses, matched by index.

    Returns the reference's six-number summary, or None with fewer than
    two matched poses (RPE needs at least one consecutive pair).
    """
    if len(ests) < 2 or len(ests) != len(gts):
        return None
    ate, t_rpe, r_rpe = [], [], []
    for i, (est, gt) in enumerate(zip(ests, gts)):
        delta = se2_compose_np(se2_inverse_np(gt), est)
        ate.append(np.linalg.norm(delta[:2]))
        if i > 0:
            rel = se2_compose_np(se2_inverse_np(ests[i - 1]), est)
            rel_gt = se2_compose_np(se2_inverse_np(gts[i - 1]), gt)
            d = se2_compose_np(se2_inverse_np(rel_gt), rel)
            t_rpe.append(np.linalg.norm(d[:2]))
            r_rpe.append(abs(d[2]))
    return {
        "ATE_mean": float(np.mean(ate)),
        "ATE_std": float(np.std(ate)),
        "t_RPE_mean": float(np.mean(t_rpe)),
        "t_RPE_std": float(np.std(t_rpe)),
        "r_RPE_mean": float(np.mean(r_rpe)),
        "r_RPE_std": float(np.std(r_rpe)),
    }
