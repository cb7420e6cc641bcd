"""Raycast lidar simulator: KITTI-like scans with real sensor geometry.

A copy of the JAX package's io/lidar_sim.py (numpy only). It raycasts the
CityWorld analytically (vertical wall quads + ground plane) into scans with
64 elevation rings, an azimuth sweep, nearest-surface occlusion, range
noise and dropouts; the same seed gives the same bytes as the reference.

HDL-64E-like pattern: 64 beams, elevations +2.0 deg .. -24.8 deg,
configurable azimuth resolution.
"""

import dataclasses
import math
from typing import Optional

import numpy as np

from .kitti import CityWorld, make_city_world


@dataclasses.dataclass(frozen=True)
class LidarModel:
    n_beams: int = 64
    elev_top_deg: float = 2.0
    elev_bottom_deg: float = -24.8
    azimuth_step_deg: float = 0.4       # real HDL-64: ~0.17; 0.4 keeps
                                        # frames ~58k rays (fast + dense)
    max_range: float = 80.0
    min_range: float = 1.0
    noise_sigma: float = 0.02           # per-return range noise (m)
    dropout: float = 0.05               # fraction of rays w/o return
    wall_height: float = 4.5


def _wall_segments(world: CityWorld):
    """All building wall segments as (S,2) a-points and (S,2) b-points."""
    a_list, b_list = [], []
    for rect in world.buildings:
        for i in range(4):
            a_list.append(rect[i])
            b_list.append(rect[(i + 1) % 4])
    return np.asarray(a_list, np.float64), np.asarray(b_list, np.float64)


def raycast_scan(world: CityWorld, pose2d, sensor_height=1.8,
                 model: LidarModel = LidarModel(), seed=0,
                 chunk=8192) -> np.ndarray:
    """One lidar frame from SE2 ``pose2d`` -> (N,3) float32 sensor-frame
    points (z relative to the sensor). Nearest-surface-wins occlusion."""
    x, y, th = float(pose2d[0]), float(pose2d[1]), float(pose2d[2])
    rng = np.random.default_rng(seed)

    elev = np.deg2rad(np.linspace(model.elev_top_deg, model.elev_bottom_deg,
                                  model.n_beams))
    azim = np.deg2rad(np.arange(0.0, 360.0, model.azimuth_step_deg))
    az, el = np.meshgrid(azim, elev)
    az = az.ravel()
    el = el.ravel()
    # ray directions in the WORLD frame (sensor yaw folded into azimuth)
    ce = np.cos(el)
    d = np.stack([ce * np.cos(az + th), ce * np.sin(az + th), np.sin(el)], 1)
    o = np.array([x, y, sensor_height])

    seg_a, seg_b = _wall_segments(world)
    seg_d = seg_b - seg_a                       # (S,2)
    # outward normal of each wall plane (unnormalized perp)
    seg_n = np.stack([seg_d[:, 1], -seg_d[:, 0]], 1)
    seg_len2 = np.maximum(np.sum(seg_d * seg_d, 1), 1e-12)

    pts = []
    for s0 in range(0, len(d), chunk):
        dc = d[s0:s0 + chunk]                   # (C,3)
        t_best = np.full(len(dc), np.inf)

        # ground plane z=0 (only downward rays)
        dz = dc[:, 2]
        tg = np.where(dz < -1e-9, -o[2] / np.where(dz < -1e-9, dz, -1.0),
                      np.inf)
        t_best = np.minimum(t_best, tg)

        # vertical wall quads: solve on the 2-D projection
        denom = np.einsum("cd,sd->cs", dc[:, :2], seg_n)      # (C,S)
        num = np.einsum("sd,sd->s", seg_a - o[:2], seg_n)     # (S,)
        with np.errstate(divide="ignore", invalid="ignore"):
            t = num[None, :] / denom                          # (C,S)
        t = np.where(np.abs(denom) > 1e-12, t, np.inf)
        t = np.where(t > model.min_range, t, np.inf)
        # hit point along the segment and within wall height?
        # (t = inf for misses; inf*0 warnings are benign — masked below)
        with np.errstate(invalid="ignore"):
            px = o[0] + t * dc[:, 0:1]
            py = o[1] + t * dc[:, 1:2]
            u = ((px - seg_a[:, 0]) * seg_d[:, 0]
                 + (py - seg_a[:, 1]) * seg_d[:, 1]) / seg_len2
            pz = o[2] + t * dc[:, 2:3]
        ok = (u >= 0.0) & (u <= 1.0) & (pz >= 0.0) \
            & (pz <= model.wall_height) & np.isfinite(t)
        t = np.where(ok, t, np.inf)
        t_best = np.minimum(t_best, t.min(axis=1))

        hit = (t_best > model.min_range) & (t_best < model.max_range)
        if model.dropout > 0:
            hit &= rng.random(len(dc)) >= model.dropout
        tb = t_best[hit] + rng.normal(0, model.noise_sigma, int(hit.sum()))
        p_world = o + tb[:, None] * dc[hit]
        # into the sensor frame (translate, un-rotate yaw; z rel. sensor)
        rel = p_world - o
        c, s = math.cos(th), math.sin(th)
        sx = c * rel[:, 0] + s * rel[:, 1]
        sy = -s * rel[:, 0] + c * rel[:, 1]
        pts.append(np.stack([sx, sy, rel[:, 2]], 1))
    return np.concatenate(pts).astype(np.float32)


def raycast_sequence(n_frames=10, seed=0, speed=3.0, dt=0.1,
                     world: Optional[CityWorld] = None,
                     model: LidarModel = LidarModel(), sensor_height=1.8,
                     trajectory="forward", turn_frames=None):
    """(world, [(stamp, gt_pose2d, scan)]) along the city street."""
    from .kitti import synthetic_city_sequence

    world = world or make_city_world(seed=seed)
    # reuse the trajectory integrator, ignore its sampled points
    world, frames = synthetic_city_sequence(
        n_frames=n_frames, seed=seed, speed=speed, dt=dt, world=world,
        trajectory=trajectory, turn_frames=turn_frames,
    )
    out = []
    for k, fr in enumerate(frames):
        scan = raycast_scan(world, fr.gt_pose, sensor_height, model,
                            seed=seed + 1000 + k)
        out.append((fr.stamp, fr.gt_pose, scan))
    return world, out


def raycast_city_sequence(n_frames=10, seed=0, speed=3.0, dt=0.1,
                          world: Optional[CityWorld] = None,
                          model: LidarModel = LidarModel(),
                          sensor_height=1.8, trajectory="forward",
                          turn_frames=None,
                          gps_noise_std=0.0, gps_walk_std=0.0):
    """Like kitti.synthetic_city_sequence but with raycast scans.

    Returns (world, [Frame]) — same Frame records (stamp, points,
    gt_pose, gps) as the point-soup sampler, with ``points`` replaced by
    occluded 64-beam raycast returns. This is the honest workload for
    the headline benchmarks: uniform-density point soup
    flatters registration convergence; real scans have beam structure,
    occlusion and range falloff.
    """
    from .kitti import synthetic_city_sequence

    world = world or make_city_world(seed=seed)
    world, frames = synthetic_city_sequence(
        n_frames=n_frames, seed=seed, speed=speed, dt=dt, world=world,
        trajectory=trajectory, turn_frames=turn_frames,
        gps_noise_std=gps_noise_std, gps_walk_std=gps_walk_std,
    )
    for k, fr in enumerate(frames):
        fr.points = raycast_scan(world, fr.gt_pose, sensor_height, model,
                                 seed=seed + 1000 + k)
    return world, frames


def save_kitti_bin(path, points, reflectance=None):
    """Write a scan in the genuine KITTI raw .bin layout (x,y,z,r f32)."""
    n = len(points)
    arr = np.zeros((n, 4), np.float32)
    arr[:, :3] = points
    if reflectance is not None:
        arr[:, 3] = reflectance
    arr.tofile(str(path))
