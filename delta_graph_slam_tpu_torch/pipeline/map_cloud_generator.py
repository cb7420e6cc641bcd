"""Map cloud assembly from keyframe snapshots.

Mirrors MapCloudGenerator (map_cloud_generator.cpp): concatenate each
snapshot's cloud transformed by its optimized pose, then optionally
octree-downsample to occupied-voxel centers at ``resolution`` (:38-49).
The clouds are posed on the host in float64, as the JAX package does, and
downsampled on the device they came from. Returns numpy (N,3).
"""

import numpy as np
import torch

from ..geom.host import transform_2d_to_3d_np
from ..ops.cloud import MaskedCloud
from ..ops.voxel import occupied_voxel_centers


class MapCloudGenerator:
    def generate(self, snapshots, resolution=0.05):
        if not snapshots:
            return np.zeros((0, 3))
        parts = []
        for s in snapshots:
            T = transform_2d_to_3d_np(s.pose)
            pts = s.cloud.points.cpu().numpy()[s.cloud.mask.cpu().numpy()]
            parts.append(pts @ T[:3, :3].T + T[:3, 3])
        cloud = np.concatenate(parts, axis=0)
        if resolution and resolution > 0 and len(cloud):
            dev = snapshots[0].cloud.points.device
            mc = MaskedCloud(torch.as_tensor(cloud, dtype=torch.float32, device=dev),
                             torch.ones(len(cloud), dtype=torch.bool, device=dev))
            out = occupied_voxel_centers(mc, resolution)
            return out.points[out.mask].cpu().numpy()
        return cloud
