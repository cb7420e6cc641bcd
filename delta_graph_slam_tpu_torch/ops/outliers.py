"""Outlier-removal filters (pcl::StatisticalOutlierRemoval / RadiusOutlierRemoval).

Reference behaviour (prefiltering_nodelet.cpp:77-98, :262-273):

- STATISTICAL(mean_k, stddev_mul): mean euclidean distance to the mean_k
  nearest neighbours (excluding self); keep points whose mean distance is
  below global_mean + stddev_mul * global_std.
- RADIUS(radius, min_neighbors): keep points with at least min_neighbors
  other points within radius.
"""

import torch

from .cloud import MaskedCloud
from .knn import knn, radius_count
from .normals import OFFSETS_27
from .voxel import build_voxel_hash
from .voxel_knn import voxel_radius_count


def statistical_outlier_removal(
    cloud: MaskedCloud, mean_k: int = 20, stddev_mul: float = 1.0, *, chunk=1024
) -> MaskedCloud:
    d2, _ = knn(
        cloud.points, cloud.mask, cloud.points, cloud.mask,
        k=mean_k, exclude_self=True, chunk=chunk,
    )
    # mean over the k neighbour euclidean distances (inf -> missing neighbour)
    finite = torch.isfinite(d2)
    d = torch.sqrt(torch.where(finite, d2, 0.0))
    cnt = torch.clamp(finite.sum(1), min=1)
    mean_d = d.sum(1) / cnt

    nvalid = torch.clamp(cloud.mask.sum(), min=1)
    mu = torch.where(cloud.mask, mean_d, 0.0).sum() / nvalid
    var = torch.where(cloud.mask, (mean_d - mu) ** 2, 0.0).sum() / nvalid
    thresh = mu + stddev_mul * torch.sqrt(var)
    keep = cloud.mask & (mean_d <= thresh)
    return MaskedCloud(cloud.points, keep)


def radius_outlier_removal(
    cloud: MaskedCloud, radius: float = 0.8, min_neighbors: int = 2, *,
    chunk=2048, method="brute", voxel_window=16,
) -> MaskedCloud:
    """method='voxel' counts neighbours among windowed hash candidates (cell
    size = radius, 27-neighbourhood): exact unless a cell holds more than
    ``voxel_window`` points, where it may undercount. 'brute' counts
    exactly. The reference's 'dense' path (ops/moments.py) is not ported
    yet."""
    if method == "voxel":
        vh = build_voxel_hash(cloud, radius, cloud.capacity,
                              dense_index=True, with_stats=False)
        cnt = voxel_radius_count(vh, cloud.points, cloud.mask, radius,
                                 OFFSETS_27, window=voxel_window)
    elif method == "brute":
        cnt = radius_count(cloud.points, cloud.mask, radius, chunk=chunk)
    else:
        raise NotImplementedError(f"neighbour method {method!r} is not ported")
    keep = cloud.mask & (cnt >= min_neighbors)
    return MaskedCloud(cloud.points, keep)
