"""KITTI-style Mercator projection between GPS and local metric frames.

Semantics of translation_from_gps_msg / gps_msg_from_translation
(ros_utils.cpp:168-194): a spherical Mercator scaled by ``scale = cos(lat0 * pi / 180)`` shared across the run.

Host numpy (float64) on purpose: these are per-message scalar
conversions on the orchestration path, and float32's ~1 m ulp at Mercator
magnitudes (~1e7 m) would quantize the GPS priors; the reference's doubles
(ros_utils.cpp:168) need float64.
"""

import numpy as np

EARTH_RADIUS_M = 6378137.0


def mercator_scale(lat0_deg):
    """Shared projection scale from the first GPS fix latitude (degrees)."""
    return np.cos(np.deg2rad(np.float64(lat0_deg)))


def mercator_from_gps(lat_deg, lon_deg, alt=0.0, *, scale):
    """(lat, lon, alt) -> local metric (x, y, z) (ros_utils.cpp:168-180)."""
    lat_deg = np.asarray(lat_deg, np.float64)
    lon_deg = np.asarray(lon_deg, np.float64)
    x = scale * lon_deg * np.pi * EARTH_RADIUS_M / 180.0
    y = scale * EARTH_RADIUS_M * np.log(
        np.tan((90.0 + lat_deg) * np.pi / 360.0)
    )
    z = np.broadcast_to(np.asarray(alt, np.float64), x.shape)
    return np.stack([x, y, z], axis=-1)


def gps_from_mercator(xyz, *, scale):
    """Local metric (..., 3) -> (lat, lon, alt) (ros_utils.cpp:183-194)."""
    xyz = np.asarray(xyz, np.float64)
    lon = xyz[..., 0] / (scale * np.pi * EARTH_RADIUS_M / 180.0)
    lat = (
        np.arctan(np.exp(xyz[..., 1] / (scale * EARTH_RADIUS_M))) * 360.0 / np.pi
        - 90.0
    )
    return np.stack([lat, lon, xyz[..., 2]], axis=-1)
