"""The port's front ends at the presets' full widths on the CPU, held to the
JAX package's own drives in tests/data/reference_drives.npz (recorded by
scripts/reference_drives.py; both packages driven by the same code over the
frames chip_smoke.py builds): phase 4's frames through the delta preset's
FAST_GICP odometry and phase 11's NDT_OMP and FAST_VGICP heads, and phase
14's MultiBagOdometry at B = 8 with voxel correspondences. Tier 1 drives a
prefix of each; the whole drives are the slow cases of
tests/test_torch_reference_drives.py.
"""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
import reference_drives as rd  # noqa: E402

torch.set_num_threads(4)

PORT = "delta_graph_slam_tpu_torch"
FRONT_PREFIX = 12       # frames of phase 4's drive
MB_PREFIX = 5           # lockstep steps of the multi-bag drive


@pytest.fixture(scope="module")
def reference():
    return cs.load_reference()[0]


@pytest.fixture(scope="module")
def frames():
    return rd.front_frames(MB_PREFIX + cs.MB_BAGS - 1)


def prefix(arrays, n):
    return {k: v[:n] for k, v in arrays.items()}


@pytest.mark.parametrize("name", ["front", "front_ndt_omp", "front_fast_vgicp"])
def test_front_prefix_matches_reference(reference, frames, name):
    """Every frame's odometry and GN iteration count over the prefix."""
    fr, gts = frames[0][:FRONT_PREFIX], frames[1][:FRONT_PREFIX]
    pipe = rd.front(PORT, name, fr, gts, stop=FRONT_PREFIX, device="cpu")
    c = cs.compare_odometry(cs.front_arrays(pipe.front_odometry),
                            prefix(reference[name], FRONT_PREFIX))
    # float32 registration in both packages, summed in other orders; over
    # these frames on the CPU the poses part by at most 0.45 mm / 3.7e-5 rad
    # (front, at frame 1), 6.5e-6 m / 1.2e-6 rad (NDT_OMP, which stays at
    # the keyframe in both packages) and
    # 0.22 mm / 1.6e-5 rad (FAST_VGICP); the bounds are ~2.5x the largest,
    # and the GN iteration counts are equal
    assert c["position_gap"] <= 2e-3 and c["rotation_gap"] <= 2e-4, c
    assert c["iterations_differ"] == 0, c


def test_multibag_prefix_matches_reference(reference, frames):
    """Every bag's odometry and GN iterations over the first lockstep
    steps of MultiBagOdometry at B = MB_BAGS, voxel correspondences."""
    clouds = [out.filtered3d for out in rd.prefiltered(PORT, frames[0], "cpu")]
    got = rd.multibag(PORT, clouds, n_steps=MB_PREFIX)
    c = cs.compare_odometry(got, prefix(reference["multibag_voxel"], MB_PREFIX - 1))
    # measured 0.88 mm / 8.3e-5 rad on the CPU (bag 5, step 1), iteration
    # counts equal; bounds ~2.3x
    assert c["position_gap"] <= 2e-3 and c["rotation_gap"] <= 2e-4, c
    assert c["iterations_differ"] == 0, c
