"""Numpy hand-over between the JAX reference and this port.

The state that crosses between the packages is clouds, masks, 4x4 poses and
configuration values, all as numpy or plain Python values.
"""

import dataclasses

import numpy as np
import torch

from .config.presets import PipelineConfig
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
    recursively. Reference fields the port has no counterpart for yet (the
    backend's buildings, loops and solver settings) are not carried.
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
