"""Synthetic city world and its point-soup scan sequence (numpy only).

A copy of the JAX package's io/kitti.py (CityWorld, make_city_world,
Frame, synthetic_city_sequence): a deterministic generated world (ground
plane, building rectangles, a smooth vehicle trajectory) producing
per-frame lidar-like scans, GPS fixes, ground-truth poses and matching
OSM XML. The same seed gives the same arrays as the reference.
"""

import dataclasses
import math
from typing import List

import numpy as np

EARTH_RADIUS_M = 6378137.0  # WGS84 equatorial radius (geom/projection.py)


@dataclasses.dataclass
class CityWorld:
    buildings: List[np.ndarray]      # list of (4,2) rectangle corners (map)
    ground_pts: np.ndarray           # (G,3)
    wall_pts: np.ndarray             # (W,3)
    origin_gps: tuple                # (lat0, lon0)
    scale: float

    def osm_xml(self) -> str:
        """Matching Overpass XML for the buildings (closed ways)."""
        lat0, lon0 = self.origin_gps
        scale = self.scale
        x0 = scale * lon0 * math.pi * EARTH_RADIUS_M / 180.0
        y0 = scale * EARTH_RADIUS_M * math.log(
            math.tan((90.0 + lat0) * math.pi / 360.0)
        )

        def to_gps(x, y):
            lon = (x + x0) / (scale * math.pi * EARTH_RADIUS_M / 180.0)
            lat = (
                math.atan(math.exp((y + y0) / (scale * EARTH_RADIUS_M)))
                * 360.0 / math.pi - 90.0
            )
            return lat, lon

        parts = ["<osm>"]
        nid = 1
        for wi, rect in enumerate(self.buildings):
            refs = []
            for cx, cy in rect:
                lat, lon = to_gps(cx, cy)
                parts.append(
                    f'<node id="{nid}" lat="{lat:.10f}" lon="{lon:.10f}"/>'
                )
                refs.append(nid)
                nid += 1
            parts.append(f'<way id="w{wi}">')
            for r in refs + [refs[0]]:
                parts.append(f'<nd ref="{r}"/>')
            parts.append('<tag k="building" v="yes"/>')
            parts.append("</way>")
        parts.append("</osm>")
        return "\n".join(parts)


def _rect_corners(cx, cy, w, h, angle=0.0):
    local = np.array([
        [-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2], [-w / 2, h / 2],
    ])
    c, s = np.cos(angle), np.sin(angle)
    R = np.array([[c, -s], [s, c]])
    return local @ R.T + np.array([cx, cy])


def make_city_world(seed=0, n_buildings=14, extent=120.0,
                    wall_spacing=0.35, ground_spacing=1.2,
                    lat0=49.0, lon0=8.4) -> CityWorld:
    rng = np.random.default_rng(seed)
    scale = math.cos(math.radians(lat0))
    rects = []
    # buildings along a street corridor (the trajectory runs along x)
    for k in range(n_buildings):
        side = 1 if k % 2 == 0 else -1
        cx = -extent / 2 + (k // 2) * (extent / max(n_buildings // 2, 1)) \
            + rng.uniform(-3, 3)
        cy = side * rng.uniform(12.0, 22.0)
        w = rng.uniform(8, 18)
        h = rng.uniform(8, 14)
        # every third facade sits oblique to the street (15-60 deg), as
        # real blocks do. A perfectly axis-aligned corridor shows the
        # lidar only grazing-incidence short walls, leaving the
        # street-direction translation nearly unobservable to scan
        # matching — a degenerate scene no real drive sustains (the
        # registration honestly slides there, measured 0.3 of 0.9 m
        # recovered on 32-beam scans even with exact correspondences)
        ang = rng.uniform(np.pi / 12, np.pi / 3) if k % 3 == 2 else 0.0
        rects.append(_rect_corners(cx, cy, w, h, ang))

    walls = []
    for rect in rects:
        for i in range(4):
            a = rect[i]
            b = rect[(i + 1) % 4]
            seg = b - a
            L = np.linalg.norm(seg)
            n = max(2, int(L / wall_spacing))
            t = np.linspace(0, 1, n)
            xy = a[None, :] + t[:, None] * seg[None, :]
            for z in np.arange(0.3, 4.5, 0.8):
                walls.append(
                    np.concatenate([xy, np.full((n, 1), z)], axis=1)
                )
    wall_pts = np.concatenate(walls)
    wall_pts = wall_pts + rng.normal(0, 0.012, wall_pts.shape)

    gx = np.arange(-extent / 2 - 30, extent / 2 + 30, ground_spacing)
    gy = np.arange(-35, 35, ground_spacing)
    gxx, gyy = np.meshgrid(gx, gy)
    ground = np.stack(
        [gxx.ravel(), gyy.ravel(), np.zeros(gxx.size)], axis=1
    )
    ground = ground + rng.normal(0, 0.01, ground.shape)
    return CityWorld(rects, ground, wall_pts, (lat0, lon0), scale)


@dataclasses.dataclass
class Frame:
    stamp: float
    points: np.ndarray       # (N,3) sensor frame
    gt_pose: np.ndarray      # (3,) SE2 map pose
    gps: tuple               # (lat, lon)


def synthetic_city_sequence(
    n_frames=60, seed=0, speed=2.0, dt=0.1, max_range=45.0,
    sensor_height=1.8, yaw_rate=0.15, world: CityWorld = None,
    trajectory="forward", turn_frames=None,
    gps_noise_std=0.0, gps_walk_std=0.0,
):
    """Generate (world, [Frame]) along one of two trajectories.

    trajectory='forward': a gently curving forward path (never revisits).
    trajectory='lap': out-and-back — drive straight ~45% of the frames,
    u-turn over ~10%, return parallel to the outbound leg a couple of
    meters off. The return pass comes within loop-closure range of the
    outbound keyframes while the accumulated travel keeps growing, which
    exercises the LoopDetector gates
    (loop_detector.hpp:83-111).

    gps_noise_std / gps_walk_std (meters): per-frame iid noise and a
    random-walk bias on the reported GPS fix. Real urban GNSS carries
    a slowly-varying multipath bias of meters — a noiseless fix makes
    any GPS-prior pipeline trivially optimal and un-benchmarkable
    against the building-constraint machinery the delta fork exists for
    (delta_graph_slam_nodelet.cpp:361-459 consumes
    the fix as-is; its accuracy is whatever the receiver gives)."""
    world = world or make_city_world(seed=seed)
    rng = np.random.default_rng(seed + 1)
    all_pts = np.concatenate([world.wall_pts, world.ground_pts])

    lat0, lon0 = world.origin_gps
    scale = world.scale
    import math as m

    x0 = scale * lon0 * m.pi * EARTH_RADIUS_M / 180.0
    y0 = scale * EARTH_RADIUS_M * m.log(m.tan((90.0 + lat0) * m.pi / 360.0))

    frames = []
    x, y, th = -50.0, 0.0, 0.0
    gbx, gby = 0.0, 0.0            # GPS random-walk bias state
    for k in range(n_frames):
        stamp = k * dt
        # scan: points within range, in sensor frame (sensor at height)
        rel = all_pts[:, :2] - np.array([x, y])
        d = np.linalg.norm(rel, axis=1)
        sel = d < max_range
        pts = all_pts[sel].copy()
        c, s = np.cos(th), np.sin(th)
        R = np.array([[c, s], [-s, c]])  # world->sensor
        xy = (pts[:, :2] - [x, y]) @ R.T
        z = pts[:, 2] - sensor_height
        scan = np.concatenate([xy, z[:, None]], axis=1).astype(np.float32)
        scan += rng.normal(0, 0.008, scan.shape).astype(np.float32)
        # subsample to bound size
        if len(scan) > 30000:
            idx = rng.choice(len(scan), 30000, replace=False)
            scan = scan[idx]

        # frame 0 stays noise-free: the first fix defines the shared
        # map/Mercator origin (backend + building frame + gt re-anchor
        # all assume it), so noise there would add a constant offset to
        # every ATE that no estimator could observe or remove
        if k > 0:
            gbx += rng.normal(0.0, gps_walk_std)
            gby += rng.normal(0.0, gps_walk_std)
            gx = x + gbx + rng.normal(0.0, gps_noise_std)
            gy = y + gby + rng.normal(0.0, gps_noise_std)
        else:
            gx, gy = x, y
        lon = (gx + x0) / (scale * m.pi * EARTH_RADIUS_M / 180.0)
        lat = (
            m.atan(m.exp((gy + y0) / (scale * EARTH_RADIUS_M))) * 360.0 / m.pi
            - 90.0
        )
        frames.append(Frame(stamp, scan, np.array([x, y, th]), (lat, lon)))

        # advance
        if trajectory == "lap":
            n_turn = turn_frames or max(6, int(n_frames * 0.10))
            n_out = (n_frames - n_turn) // 2
            if n_out <= k < n_out + n_turn:
                th += m.pi / n_turn
        else:
            th += yaw_rate * dt * np.sin(k * 0.12)
        x += speed * dt * np.cos(th)
        y += speed * dt * np.sin(th)
    return world, frames
