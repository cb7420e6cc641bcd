"""Numpy hand-over between the JAX reference and this port.

The state that crosses between the packages is clouds, masks, 4x4 poses,
configuration values and pose graphs, all as numpy or plain Python values.
"""

import dataclasses

import numpy as np
import torch

from .config.presets import PipelineConfig
from .graph.robust import ROBUST_KERNELS
from .graph.se2_graph import SE2GraphBuilder
from .graph.se3_graph import SE3GraphBuilder
from .ops.cloud import MaskedCloud, make_cloud


def cloud_from_numpy(points, mask, device="cpu") -> MaskedCloud:
    """MaskedCloud on ``device`` from (N,3) points and an (N,) mask."""
    return make_cloud(np.asarray(points, np.float32), np.asarray(mask, bool),
                      device=device)


def _numpy(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def cloud_to_numpy(cloud):
    """(points (N,3) float32, mask (N,) bool) of a cloud of either package."""
    return (_numpy(cloud.points).astype(np.float32, copy=False),
            _numpy(cloud.mask).astype(bool, copy=False))


def config_from_reference_fields(fields: dict, cls=PipelineConfig):
    """Build the port's frozen config ``cls`` from ``dataclasses.asdict`` of
    the reference's counterpart.

    Every field of ``cls`` must be present; nested configs are built
    recursively, so the backends' solver, registration, line-matcher,
    information-matrix and floor-detection settings carry across; a nested
    config the preset leaves out (``delta`` of an hdl preset) stays None.
    """
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in fields:
            raise KeyError(f"{cls.__name__}.{f.name} missing from the reference fields")
        value = fields[f.name]
        if dataclasses.is_dataclass(f.type) and isinstance(value, dict):
            value = config_from_reference_fields(value, f.type)
        kw[f.name] = value
    return cls(**kw)


def builder_from_reference(ref, device="cpu") -> SE2GraphBuilder:
    """The port's SE2GraphBuilder holding the same graph as a reference
    builder: vertices, fixed flags and edge records (ids included), with
    arrays as numpy in the reference builder's dtype."""
    b = SE2GraphBuilder(dtype=ref.dtype, device=device)
    for pose, fixed in zip(ref.poses, ref.fixed):
        b.add_vertex(np.asarray(pose), fixed=fixed)
    for e in ref.edges:
        b._add_edge(e["type"], e["i"], e["j"], np.asarray(e["meas"]),
                    np.asarray(e["info"]), e["level"], ROBUST_KERNELS[e["kernel"]],
                    e["delta"])
        b.edges[-1]["id"] = e["id"]
    b._next_edge_id = ref._next_edge_id
    return b


def se3_builder_from_reference(ref, device="cpu") -> SE3GraphBuilder:
    """The port's SE3GraphBuilder holding the same graph as a reference
    builder: poses, planes, points, fixed flags and the edge records (ids
    and kernel ids included), with arrays as numpy in the reference
    builder's dtype."""
    b = SE3GraphBuilder(dtype=ref.dtype, device=device)
    b.poses = [np.asarray(p, ref.dtype) for p in ref.poses]
    b.planes = [np.asarray(p, ref.dtype) for p in ref.planes]
    b.points = [np.asarray(p, ref.dtype) for p in ref.points]
    b.fixed = list(ref.fixed)
    b.plane_fixed = list(ref.plane_fixed)
    b.point_fixed = list(ref.point_fixed)
    b.edges = [{k: np.asarray(v) if k in ("meas", "info") else v
                for k, v in e.items()} for e in ref.edges]
    b._next_edge_id = ref._next_edge_id
    return b
