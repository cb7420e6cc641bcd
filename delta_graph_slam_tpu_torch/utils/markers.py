"""Visualization dumps (the rviz-config equivalent for a headless stack).

A copy of the JAX package's utils/markers.py (host numpy): the same
marker dict gives the same markers.json and markers.svg bytes. The
reference publishes six MarkerArray namespaces for rviz
(delta_graph_slam_nodelet.cpp:934-1154, config rviz/delta_graph_slam.rviz).
Headless equivalent: write the same content as JSON + an optional
matplotlib figure for quick inspection (False without matplotlib).
"""

import json

import numpy as np


def dump_markers_json(markers: dict, path):
    def conv(x):
        if isinstance(x, np.ndarray):
            return x.tolist()
        return x

    with open(path, "w") as f:
        json.dump({k: conv(v) for k, v in markers.items()}, f, indent=2)


def plot_markers(markers: dict, path, map_cloud=None):
    """Write a PNG with trajectory, buildings, gps and gt overlays."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return False

    fig, ax = plt.subplots(figsize=(10, 10))
    if map_cloud is not None and len(map_cloud):
        ax.scatter(map_cloud[:, 0], map_cloud[:, 1], s=0.2, c="#cccccc",
                   label="map")
    kf = np.asarray(markers.get("keyframe_nodes", np.zeros((0, 2))))
    if len(kf):
        ax.plot(kf[:, 0], kf[:, 1], "b.-", ms=4, lw=1, label="keyframes")
    bn = np.asarray(markers.get("building_nodes", np.zeros((0, 2))))
    if len(bn):
        ax.plot(bn[:, 0], bn[:, 1], "rs", ms=6, label="buildings")
    gps = np.asarray(markers.get("gps", np.zeros((0, 2))))
    if len(gps):
        ax.plot(gps[:, 0], gps[:, 1], "g^", ms=4, label="gps")
    gt = np.asarray(markers.get("gt_pose", np.zeros((0, 2))))
    if len(gt):
        ax.plot(gt[:, 0], gt[:, 1], "k--", lw=1, label="ground truth")
    ax.set_aspect("equal")
    ax.legend(loc="best")
    ax.set_title("delta_graph_slam_tpu")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
    return True


def render_markers_svg(markers: dict, path, map_cloud=None,
                       size=900, margin=40):
    """Dependency-free SVG render of the marker namespaces (the rviz
    stand-in that needs no matplotlib): map points, graph edges colored
    by level, keyframe trajectory, buildings, gps, ground truth."""
    pts = [np.asarray(markers.get(k, np.zeros((0, 2))), float).reshape(-1, 2)
           for k in ("keyframe_nodes", "building_nodes", "gps", "gt_pose")]
    node_xy = np.asarray(markers.get("node_xy", np.zeros((0, 2))), float)
    all_xy = np.concatenate(
        [p for p in pts if len(p)] + ([node_xy] if len(node_xy) else [])
        + ([np.asarray(map_cloud, float)[:, :2]]
           if map_cloud is not None and len(map_cloud) else [])
        or [np.zeros((1, 2))]
    )
    lo = all_xy.min(axis=0) - 1.0
    hi = all_xy.max(axis=0) + 1.0
    span = max(float((hi - lo).max()), 1e-6)
    s = (size - 2 * margin) / span

    def tx(p):
        return (margin + (p[0] - lo[0]) * s,
                size - margin - (p[1] - lo[1]) * s)

    out = [f'<svg xmlns="http://www.w3.org/2000/svg" width="{size}" '
           f'height="{size}" viewBox="0 0 {size} {size}">',
           f'<rect width="{size}" height="{size}" fill="white"/>']
    if map_cloud is not None and len(map_cloud):
        mc = np.asarray(map_cloud, float)[:, :2]
        step = max(1, len(mc) // 20000)
        for p in mc[::step]:
            x, y = tx(p)
            out.append(f'<circle cx="{x:.1f}" cy="{y:.1f}" r="0.7" '
                       'fill="#cccccc"/>')
    level_color = {0: "#888888", 1: "#cc8800", 2: "#cc0000"}
    for e in markers.get("edges", []):
        i, j = int(e[0]), int(e[1])
        lvl = int(e[2]) if len(e) > 2 else 0
        if i < len(node_xy) and j < len(node_xy):
            x1, y1 = tx(node_xy[i])
            x2, y2 = tx(node_xy[j])
            out.append(
                f'<line x1="{x1:.1f}" y1="{y1:.1f}" x2="{x2:.1f}" '
                f'y2="{y2:.1f}" stroke="{level_color.get(lvl, "#888888")}" '
                'stroke-width="0.8"/>'
            )
    kf, bn, gps, gt = pts
    if len(gt):
        d = " ".join(f'{tx(p)[0]:.1f},{tx(p)[1]:.1f}' for p in gt)
        out.append(f'<polyline points="{d}" fill="none" stroke="black" '
                   'stroke-dasharray="6 4" stroke-width="1.2"/>')
    if len(kf):
        d = " ".join(f'{tx(p)[0]:.1f},{tx(p)[1]:.1f}' for p in kf)
        out.append(f'<polyline points="{d}" fill="none" stroke="#1f55cc" '
                   'stroke-width="1.5"/>')
        for p in kf:
            x, y = tx(p)
            out.append(f'<circle cx="{x:.1f}" cy="{y:.1f}" r="2.5" '
                       'fill="#1f55cc"/>')
    for p in bn:
        x, y = tx(p)
        out.append(f'<rect x="{x - 4:.1f}" y="{y - 4:.1f}" width="8" '
                   'height="8" fill="#cc2222"/>')
    for p in gps:
        x, y = tx(p)
        out.append(f'<path d="M {x:.1f} {y - 4:.1f} L {x - 4:.1f} '
                   f'{y + 3:.1f} L {x + 4:.1f} {y + 3:.1f} Z" '
                   'fill="#22aa22"/>')
    out.append("</svg>")
    with open(path, "w") as f:
        f.write("\n".join(out))
    return True


def save_viz(markers: dict, out_dir, map_cloud=None):
    """markers.json + markers.svg (+ markers.png when matplotlib exists)."""
    import os

    os.makedirs(out_dir, exist_ok=True)
    dump_markers_json(markers, os.path.join(out_dir, "markers.json"))
    render_markers_svg(markers, os.path.join(out_dir, "markers.svg"),
                       map_cloud=map_cloud)
    return plot_markers(markers, os.path.join(out_dir, "markers.png"),
                        map_cloud=map_cloud)
