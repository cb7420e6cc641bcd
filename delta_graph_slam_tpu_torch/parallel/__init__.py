"""Batched registration and the segmented pose-graph solve (the JAX
package's device-mesh scaling, on one card: the mesh axes become batch
dimensions)."""

from .sharding import (
    make_mesh,
    batched_align,
    batched_align_sharded,
    optimize_se2_sharded,
    shard_graph_edges,
)
from .multibag import MultiBagOdometry

__all__ = [
    "make_mesh", "batched_align", "batched_align_sharded",
    "optimize_se2_sharded", "shard_graph_edges", "MultiBagOdometry",
]
