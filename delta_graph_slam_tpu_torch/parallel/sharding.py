"""The JAX package's device-mesh scaling, on torch devices.

The JAX package scales over a ``jax.sharding.Mesh`` on two axes:

- ``dp`` (data parallel): batched scan registration, B (source, target,
  guess) problems in one program with the batch sharded over the mesh
  (multi-bag replay, loop-candidate validation, BASELINE.json config 5);
- ``mp`` (model parallel): the pose-graph solve of 10k+-node graphs, the
  chain split into mesh-axis-many SPIKE segments (backend 'chain') or the
  edge tables sharded (backend 'cg').

Here a ``Mesh`` is a (dp, mp) grid of torch devices. ``dp`` splits a batch
into contiguous chunks, one a device row; ``mp`` sets the segment count of
the SPIKE solve, whose segments are a batch dimension on one device. On a
host with one card dp = mp = 1, and a batch is one launch sequence on it.
"""

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..graph.lm_core import SolverConfig
from ..graph.se2_graph import SE2Graph
from ..graph.solver import optimize_se2
from ..register.config import RegistrationConfig
from ..register.engine import RegistrationResult, _make_batched_align_fn


class Mesh:
    """A (dp, mp) grid of torch devices with the axis names ("dp", "mp")."""

    def __init__(self, devices: np.ndarray, axis_names=("dp", "mp")):
        self.devices = devices
        self.axis_names = tuple(axis_names)

    @property
    def shape(self) -> dict:
        """Axis name -> size, as jax.sharding.Mesh.shape."""
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def home(self) -> torch.device:
        """The first device: where gathered results and replicated tables
        live."""
        return self.devices.flat[0]

    def __repr__(self):
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None,
              mp: int = 1, devices=None) -> Mesh:
    """A (dp, mp) mesh of the first ``n_devices`` of ``devices`` (default:
    every CUDA device). Raises when more devices are asked for than exist,
    or when dp * mp != n_devices."""
    if devices is None:
        devices = [torch.device("cuda", k) for k in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = n_devices or len(devices)
    if n < 1 or n > len(devices):
        raise ValueError(f"a mesh of {n} devices asked for, {len(devices)} exist")
    dp = dp or (n // mp)
    if dp * mp != n:
        raise ValueError(f"dp({dp}) * mp({mp}) != n({n})")
    grid = np.empty((dp, mp), dtype=object)
    for k, d in enumerate(devices[:n]):
        grid.flat[k] = d
    return Mesh(grid, ("dp", "mp"))


def _tree_map(fn, *trees):
    """``fn`` over the tensors of NamedTuples (nested); None stays None and
    other leaves (a hash's resolution, bits) are taken from the first."""
    first = trees[0]
    if isinstance(first, torch.Tensor):
        return fn(*trees)
    if isinstance(first, tuple) and hasattr(first, "_fields"):
        return type(first)(*(_tree_map(fn, *leaves) for leaves in zip(*trees)))
    return first


# ------------------------------------------------------- batched alignment

def batched_align(cfg: RegistrationConfig):
    """Batched align: (stacked SourceModel, stacked TargetModel, guesses
    (B,4,4)) -> RegistrationResult with a leading B. One launch sequence a
    GN iteration serves the B problems (register/engine.py)."""
    return _make_batched_align_fn(cfg)


def batched_align_sharded(cfg: RegistrationConfig, mesh: Mesh):
    """Data-parallel batched align: the batch axis split into contiguous
    chunks, one for each device of the mesh's 'dp' axis; the results are
    gathered on the mesh's first device."""
    align = _make_batched_align_fn(cfg)
    rows = list(mesh.devices[:, 0])

    def run(srcs, tgts, guesses):
        guesses = torch.as_tensor(guesses)
        parts = []
        for dev, idx in zip(rows, torch.arange(guesses.shape[0]).tensor_split(len(rows))):
            if len(idx) == 0:
                continue
            sl = slice(int(idx[0]), int(idx[-1]) + 1)
            src, tgt = (_tree_map(lambda x: x[sl].to(dev), t) for t in (srcs, tgts))
            parts.append(align(src, tgt, guesses[sl].to(dev)))
        return RegistrationResult(*(torch.cat([p[k].to(mesh.home) for p in parts])
                                    for k in range(len(RegistrationResult._fields))))

    run.mesh = mesh
    return run


# -------------------------------------------------------- sharded graph solve

def shard_graph_edges(graph: SE2Graph, mesh: Mesh, axis: str = "mp") -> SE2Graph:
    """The graph on the mesh's first device with every edge table padded
    to a multiple of the mesh axis size (zero rows: masked out, inactive),
    as the JAX package pads before sharding the edge axis."""
    n_ax = mesh.shape[axis]
    home = mesh.home

    def pad(x):
        x = x.to(home)
        k = (-x.shape[0]) % n_ax
        if k:
            x = torch.cat([x, x.new_zeros((k,) + tuple(x.shape[1:]))])
        return x

    def table(t):
        return type(t)(*(pad(v) for v in t))

    return SE2Graph(poses=graph.poses.to(home), fixed=graph.fixed.to(home),
                    vmask=graph.vmask.to(home), edges=table(graph.edges),
                    priors_xy=table(graph.priors_xy),
                    priors_yaw=table(graph.priors_yaw))


def optimize_se2_sharded(graph: SE2Graph, mesh: Mesh, level=0,
                         config: SolverConfig = None, axis: str = "mp",
                         n_chain=0, off_hint=None):
    """Level-masked LM over the mesh axis.

    backend='chain' (with n_chain for the chain-first layout): the direct
    solve with SPIKE substructuring (parallel/spike.py), the chain split
    into mesh.shape[axis] segments. backend='cg': the CG LM on the graph
    with its edge tables padded by shard_graph_edges.
    """
    config = config or SolverConfig()
    if config.backend == "chain":
        config = dataclasses.replace(config, chain_segments=mesh.shape[axis],
                                     chain_mesh_axis=axis)
        return optimize_se2(graph, level=level, config=config,
                            off_hint=off_hint, n_chain=n_chain)
    return optimize_se2(shard_graph_edges(graph, mesh, axis), level=level,
                        config=config)
