"""Voxel-grid operations: downsampling, occupied-cell centers and the
voxel-hash lookup table.

Replacements for pcl::VoxelGrid (prefiltering_nodelet.cpp:55-75), the
octree's occupied-voxel centers (map_cloud_generator.cpp:38-49) and the
kd-tree of the registration engine, at fixed capacity: quantize to
integer cells, sort by cell, mark the first point of each run and reduce
each run into a fixed-capacity output.

Cell coordinates are ``floor(p * (1 / resolution))`` with the reciprocal
rounded to float32. The JAX package writes ``p / resolution``, but its
jitted programs see the resolution as a compile-time constant and XLA
turns that division into this product, so computing the product here puts
every point in the same cell as the reference's production programs do.

The per-cell sums (centroids, cell statistics) reduce each run of sorted
points in order (ops/segment.py), so a cell's sum has the same bits on
every run and, on the CPU, the bits of XLA's in-order segment_sum.
"""

from typing import NamedTuple, Optional

import numpy as np
import torch

from .cloud import MaskedCloud
from .segment import segment_sum

_I32_MAX = 2**31 - 1
DENSE_BITS = (8, 8, 6)  # default direct-address grid: 256 x 256 x 64 cells


def _inv(resolution) -> float:
    return float(np.float32(1.0) / np.float32(resolution))


def voxel_coords(points, resolution):
    """floor(p / resolution) as int32 cell coordinates (PCL convention)."""
    return torch.floor(points * _inv(resolution)).to(torch.int32)


def voxel_keys(points, mask, resolution, bits=10, origin=None):
    """Packed int32 voxel key per point; invalid points get key = 2^31-1.

    Coordinates are offset by ``origin`` (defaults to the masked min corner)
    and clamped to [0, 2^bits); 3*bits must be < 31.
    """
    if 3 * bits >= 31:
        raise ValueError(f"bits={bits}: 3*bits must be < 31")
    coords = voxel_coords(points, resolution)
    if origin is None:
        origin = torch.where(mask[:, None], coords, _I32_MAX).amin(0)
    coords = torch.clamp(coords - origin, 0, (1 << bits) - 1)
    key = (coords[:, 0] << (2 * bits)) | (coords[:, 1] << bits) | coords[:, 2]
    key = torch.where(mask, key, _I32_MAX)
    return key, origin


def _lexsort(keys):
    """Permutation that sorts lexicographically by ``keys`` (first key most
    significant), stable: chained stable sorts from the last key to the
    first, as lax.sort(num_keys=len(keys)) orders them."""
    perm = torch.arange(keys[0].shape[0], device=keys[0].device)
    for key in reversed(keys):
        perm = perm[torch.sort(key[perm], stable=True).indices]
    return perm


def _cell_hash(coords):
    """The reference's scrambled int32 cell hash, with int32 wrap-around
    made explicit: products in int64, XOR, then the low 32 bits as signed."""
    c = coords.to(torch.int64)
    h = (c[:, 0] * 73856093) ^ (c[:, 1] * 19349669) ^ (c[:, 2] * 83492791)
    return ((h & 0xFFFFFFFF) ^ 0x80000000) - 0x80000000


def _sorted_segments(points, mask, resolution, coords=None):
    """Sort points by voxel cell; return sorted pts, coords, validity and
    first-in-run flags. ``coords`` overrides the cells of voxel_coords.

    Cells are ordered by a scrambled hash of the cell coordinates (exact
    coordinates break ties, so the points of one cell stay adjacent): when
    the occupied voxels exceed the output capacity, the dropped overflow
    is a spatially unbiased subset (DIVERGENCES.md §9).
    """
    if coords is None:
        coords = voxel_coords(points, resolution)
    invalid = (~mask).to(torch.int32)
    perm = _lexsort([invalid, _cell_hash(coords), coords[:, 0], coords[:, 1],
                     coords[:, 2]])
    coords_s = coords[perm]
    valid_s = mask[perm]
    same = (coords_s[1:] == coords_s[:-1]).all(dim=1)
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=points.device),
                       ~same]) & valid_s
    return points[perm], coords_s, valid_s, first


def _segment_ids(first, valid, capacity):
    """Run index of each sorted point, non-decreasing; invalid points and
    runs beyond the capacity go to the dump slot ``capacity`` (XLA drops
    them)."""
    seg = torch.cumsum(first.to(torch.int32), 0) - 1
    return torch.where(valid & (seg < capacity), seg, capacity).to(torch.int64)


def voxel_downsample(cloud: MaskedCloud, resolution, capacity_out=None) -> MaskedCloud:
    """Centroid per occupied voxel (pcl::VoxelGrid semantics).

    Voxels beyond ``capacity_out`` (in cell-sorted order) are dropped.
    Output is compacted (valid prefix).
    """
    if capacity_out is None:
        capacity_out = cloud.capacity
    pts_s, _, valid_s, first = _sorted_segments(cloud.points, cloud.mask, resolution)
    seg = _segment_ids(first, valid_s, capacity_out)
    ones = torch.ones_like(pts_s[:, :1])
    stats = segment_sum(torch.cat([pts_s, ones], 1), seg, capacity_out,
                        sorted_ids=True)
    sums, cnts = stats[:, :3], stats[:, 3]
    mask_out = cnts > 0
    centroids = sums / torch.clamp(cnts, min=1.0)[:, None]
    return MaskedCloud(torch.where(mask_out[:, None], centroids, 0.0), mask_out)


def occupied_voxel_centers(cloud: MaskedCloud, resolution, capacity_out=None) -> MaskedCloud:
    """Center of each occupied voxel (pcl octree getOccupiedVoxelCenters
    semantics, map_cloud_generator.cpp:38-49).

    The JAX package runs this outside any jitted program, where
    ``p / resolution`` is a true division; so is this one (a division by a
    device tensor: a Python scalar divisor becomes a reciprocal multiply on
    CUDA). Each occupied cell writes its one slot: no sum, the same result
    on every device.
    """
    n = cloud.capacity
    if capacity_out is None:
        capacity_out = n
    pts = cloud.points
    coords = torch.floor(pts / torch.tensor(resolution, dtype=pts.dtype, device=pts.device))
    _, coords_s, valid_s, first = _sorted_segments(pts, cloud.mask, resolution,
                                                   coords=coords.to(torch.int32))
    seg = _segment_ids(first, first & valid_s, capacity_out)
    centers = (coords_s.to(pts.dtype) + 0.5) * resolution
    out = torch.zeros((capacity_out + 1, 3), dtype=pts.dtype, device=pts.device)
    out[seg] = centers
    mask_out = torch.zeros(capacity_out + 1, dtype=torch.bool, device=pts.device)
    mask_out[seg] = True
    mask_out = mask_out[:-1]
    return MaskedCloud(torch.where(mask_out[:, None], out[:-1], 0.0), mask_out)


class VoxelHash(NamedTuple):
    """Sorted-unique-key voxel table: the kd-tree replacement.

    Lookups go through the dense direct-address grid ``dense_slot`` when
    the hash carries one (one gather per candidate cell), and through a
    binary search over ``keys`` otherwise.
    """

    keys: torch.Tensor        # (V,) int32 sorted unique cell keys (pad = INT32_MAX)
    counts: torch.Tensor      # (V,) float
    means: torch.Tensor       # (V, 3)
    covs: torch.Tensor        # (V, 3, 3)  E[xx^T] - mean mean^T (population)
    starts: torch.Tensor      # (V,) int32 start index into sorted points
    sorted_points: torch.Tensor  # (N, 3) points sorted by cell key
    sorted_valid: torch.Tensor   # (N,) bool
    origin: torch.Tensor      # (3,) int32 cell-coordinate offset
    resolution: float
    bits: int
    dense_slot: Optional[torch.Tensor] = None  # (G,) int32, -1 = empty cell


def build_voxel_hash(cloud: MaskedCloud, resolution, capacity_voxels, bits=10,
                     dense_index=False, dense_bits=DENSE_BITS,
                     with_stats=True) -> VoxelHash:
    """Build the voxel table for a cloud.

    dense_index=True also scatters the direct-address slot grid (dense_bits
    per axis; 8,8,6 -> 4.2M int32 = 16 MB). Cells outside that box are not
    in the grid, as in the reference. with_stats=False skips the per-voxel
    mean/covariance reductions (pure NN indexes don't need them).
    """
    n = cloud.capacity
    device = cloud.points.device
    key, origin = voxel_keys(cloud.points, cloud.mask, resolution, bits=bits)
    key_s, perm = torch.sort(key, stable=True)
    pts_s = cloud.points[perm]
    valid_s = key_s != _I32_MAX
    first = torch.cat([torch.ones((1,), dtype=torch.bool, device=device),
                       key_s[1:] != key_s[:-1]]) & valid_s
    V = capacity_voxels
    segd = _segment_ids(first, valid_s, V)
    dtype = pts_s.dtype
    cols = [torch.ones_like(pts_s[:, :1])]
    if with_stats:
        cols += [pts_s, (pts_s[:, :, None] * pts_s[:, None, :]).reshape(n, 9)]
    stats = segment_sum(torch.cat(cols, 1), segd, V, sorted_ids=True)
    cnt = stats[:, 0]
    if with_stats:
        cnt_safe = torch.clamp(cnt, min=1.0)
        means = stats[:, 1:4] / cnt_safe[:, None]
        covs = (stats[:, 4:].reshape(V, 3, 3) / cnt_safe[:, None, None]
                - means[:, :, None] * means[:, None, :])
    else:
        means = torch.zeros((V, 3), dtype=dtype, device=device)
        covs = torch.zeros((V, 3, 3), dtype=dtype, device=device)
    # key and start index of each run: the run's first point carries both
    # (the reference's segment_min over the run gives the same values).
    # Every other point writes to the dump slot V, so no boolean indexing
    # (and no host sync) is needed.
    slot = torch.where(first, segd, V)
    keys_u = torch.full((V + 1,), _I32_MAX, dtype=torch.int32, device=device)
    keys_u[slot] = key_s
    starts = torch.full((V + 1,), _I32_MAX, dtype=torch.int32, device=device)
    starts[slot] = torch.arange(n, dtype=torch.int32, device=device)
    keys_u, starts = keys_u[:-1], starts[:-1]
    dense = None
    if dense_index:
        bx, by, bz = dense_bits
        occupied = keys_u != _I32_MAX
        ix = (keys_u >> (2 * bits)) & ((1 << bits) - 1)
        iy = (keys_u >> bits) & ((1 << bits) - 1)
        iz = keys_u & ((1 << bits) - 1)
        in_box = occupied & (ix < (1 << bx)) & (iy < (1 << by)) & (iz < (1 << bz))
        G = 1 << (bx + by + bz)
        flat = (ix << (by + bz)) | (iy << bz) | iz
        flat = torch.where(in_box, flat, G).to(torch.int64)  # G = dump slot
        dense = torch.full((G + 1,), -1, dtype=torch.int32, device=device)
        dense[flat] = torch.arange(V, dtype=torch.int32, device=device)
        dense = dense[:G]
    return VoxelHash(
        keys=keys_u, counts=cnt, means=means, covs=covs, starts=starts,
        sorted_points=pts_s, sorted_valid=valid_s, origin=origin,
        resolution=float(resolution), bits=bits, dense_slot=dense,
    )


def batch_take(table, idx, batched=True):
    """``table[idx]``, problem by problem for a batch: table (B, L, ...)
    and idx (B, ...) gather row idx[b, ...] of table[b] (one gather over
    the flattened table). ``batched=False`` is the plain ``table[idx]``."""
    if not batched:
        return table[idx]
    B, L = table.shape[:2]
    base = torch.arange(B, device=idx.device) * L
    flat = table.reshape((B * L,) + tuple(table.shape[2:]))
    return flat[idx + base.view((B,) + (1,) * (idx.ndim - 1))]


def voxel_lookup(vh: VoxelHash, query_points, query_mask, offsets=None,
                 dense_bits=DENSE_BITS):
    """Find the voxel slot for each query point (and optional neighbour cells).

    offsets: (M, 3) int cell offsets (e.g. 7- or 27-neighbourhood); default
    just the containing cell. Returns (slots (N, M) int64, hit (N, M) bool).
    Batched: query (B,N,3) and mask (B,N) against a hash whose tensors are
    stacked per problem (parallel/multibag.py:_stack) give (B,N,M) slots
    into each problem's own table.
    """
    device = query_points.device
    batched = query_points.ndim == 3
    if offsets is None:
        offsets = np.zeros((1, 3), np.int32)
    offsets = torch.as_tensor(np.asarray(offsets, np.int32), device=device)
    origin = vh.origin[:, None, :] if batched else vh.origin
    coords = voxel_coords(query_points, vh.resolution) - origin
    cand = coords[..., None, :] + offsets  # (..., N, M, 3)
    if vh.dense_slot is not None:
        bx, by, bz = dense_bits
        hi = torch.tensor([(1 << bx) - 1, (1 << by) - 1, (1 << bz) - 1],
                          dtype=torch.int32, device=device)
        in_range = ((cand >= 0) & (cand <= hi)).all(dim=-1)
        c = torch.minimum(torch.clamp(cand, min=0), hi)
        flat = (c[..., 0] << (by + bz)) | (c[..., 1] << bz) | c[..., 2]
        slot = batch_take(vh.dense_slot, flat.to(torch.int64), batched)
        hit = (slot >= 0) & in_range & query_mask[..., None]
        return torch.clamp(slot, min=0).to(torch.int64), hit
    bits = vh.bits
    in_range = ((cand >= 0) & (cand < (1 << bits))).all(dim=-1)
    cand = torch.clamp(cand, 0, (1 << bits) - 1)
    key = (cand[..., 0] << (2 * bits)) | (cand[..., 1] << bits) | cand[..., 2]
    flat_key = key.reshape(key.shape[0], -1) if batched else key.reshape(-1)
    slot = torch.searchsorted(vh.keys, flat_key, side="left").reshape(key.shape)
    slot = torch.clamp(slot, 0, vh.keys.shape[-1] - 1)
    hit = (batch_take(vh.keys, slot, batched) == key) & in_range & query_mask[..., None]
    return slot, hit
