"""Batched multi-bag scan-matching odometry (BASELINE.json config 5).

Runs B independent frame-to-keyframe odometry pipelines in lockstep: every
frame, the B (source, keyframe target, guess) problems are one batched
align (register/engine.py:_make_batched_align_fn), whose brute
correspondences are one launch of the 1-NN kernel for all B. Keyframe
swaps are per-bag host decisions; only the swapped bags rebuild their
target model, written into the stacked one in place.

Counterpart of the JAX package's parallel/multibag.py: the same
registration, batched to fill the card instead of running the reference
B times.
"""

from typing import List

import numpy as np
import torch

from ..geom.se3 import transform_3d_to_2d
from ..ops.cloud import MaskedCloud
from ..register.config import RegistrationConfig
from ..register.engine import _make_batched_align_fn, make_registration
from .sharding import Mesh, _tree_map, batched_align_sharded


def _stack(trees):
    """Models of B problems -> one model with a leading B on every tensor
    (every model of the batch must have the same shapes)."""
    return _tree_map(lambda *a: torch.stack(a), *trees)


def _set_slice(batched, idx, tree):
    """Write one problem's model into row ``idx`` of a stacked model."""
    def put(b, t):
        b[idx] = t
        return b

    return _tree_map(put, batched, tree)


class MultiBagOdometry:
    """Lockstep frame-to-keyframe odometry over B bags."""

    def __init__(self, cfg: RegistrationConfig, n_bags: int,
                 keyframe_delta_trans=0.25, keyframe_delta_angle=0.15,
                 mesh: Mesh = None):
        self.cfg = cfg
        self.n_bags = n_bags
        self.keyframe_delta_trans = keyframe_delta_trans
        self.keyframe_delta_angle = keyframe_delta_angle
        self.reg = make_registration(cfg)
        self.mesh = mesh
        self._align_batched = (_make_batched_align_fn(self.reg.cfg) if mesh is None
                               else batched_align_sharded(self.reg.cfg, mesh))

        self.targets = None             # stacked TargetModel (B, ...)
        self.keyframe_poses = np.tile(np.eye(4), (n_bags, 1, 1))
        self.prev_trans = np.tile(np.eye(4), (n_bags, 1, 1))
        self.initialized = np.zeros(n_bags, bool)
        self.last_result = None

    def process(self, clouds: List[MaskedCloud]):
        """One lockstep frame for all bags (clouds on the device the
        odometry runs on). Returns (B,4,4) odometry poses."""
        if len(clouds) != self.n_bags:
            raise ValueError(f"{len(clouds)} clouds for {self.n_bags} bags")
        if self.targets is None:
            self.targets = _stack([self.reg.build_target(c) for c in clouds])
            self.initialized[:] = True
            return self.keyframe_poses.copy()

        srcs = _stack([self.reg.build_source(c) for c in clouds])
        guesses = torch.as_tensor(self.prev_trans, dtype=torch.float32,
                                  device=clouds[0].points.device)
        res = self._align_batched(srcs, self.targets, guesses)
        self.last_result = res
        trans = res.transformation.to(torch.float64).cpu().numpy()
        odom = np.einsum("bij,bjk->bik", self.keyframe_poses, trans)

        # per-bag keyframe swap (host decision, target rebuilt per swapped bag)
        swapped = []
        for b in range(self.n_bags):
            dt = np.linalg.norm(trans[b, :3, 3])
            qw = np.clip(
                np.sqrt(max(0.0, 1.0 + np.trace(trans[b, :3, :3]))) / 2, -1, 1
            )
            da = np.arccos(qw)
            if dt > self.keyframe_delta_trans or da > self.keyframe_delta_angle:
                swapped.append(b)
        for b in swapped:
            self.targets = _set_slice(self.targets, b, self.reg.build_target(clouds[b]))
            self.keyframe_poses[b] = odom[b]
            self.prev_trans[b] = np.eye(4)
        for b in range(self.n_bags):
            if b not in swapped:
                self.prev_trans[b] = trans[b]
        return odom

    def poses2d(self, odom):
        """(B,4,4) odometry -> (B,3) [x, y, theta]."""
        return transform_3d_to_2d(torch.as_tensor(np.asarray(odom))).numpy()
