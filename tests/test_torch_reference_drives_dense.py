"""Phase 13's 'dense' front end (neighbor_method='dense', cov_method='dense':
the reference's own TPU main path, where 'auto' resolves to 'dense') at the
delta preset's full widths on the CPU, held to the JAX package's drive of
the same frames in tests/data/reference_drives.npz (front_dense, recorded by
scripts/reference_drives.py). Tier 1 drives a prefix: the dense methods
cost ~20 s a frame at 32768 points on an 8-core CPU; the whole drive is a slow
case of tests/test_torch_reference_drives.py.
"""

import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chip_smoke as cs  # noqa: E402
import reference_drives as rd  # noqa: E402

torch.set_num_threads(4)

PORT = "delta_graph_slam_tpu_torch"
PREFIX = 3              # the keyframe and two aligned frames


@pytest.fixture(scope="module")
def reference():
    return cs.load_reference()[0]


def test_dense_front_prefix_matches_reference(reference):
    """Every frame's odometry and GN iteration count over the prefix."""
    frames, gts = rd.front_frames(PREFIX)
    pipe = rd.front(PORT, "front_dense", frames, gts, stop=PREFIX, device="cpu")
    want = {k: v[:PREFIX] for k, v in reference["front_dense"].items()}
    c = cs.compare_odometry(cs.front_arrays(pipe.front_odometry), want)
    # measured 0.86 mm / 4.0e-5 rad on the CPU (frame 1: the moments'
    # float32 sums about each chunk's centre round in another order than
    # XLA's), iteration counts equal; bounds ~2.3x
    assert c["position_gap"] <= 2e-3 and c["rotation_gap"] <= 2e-4, c
    assert c["iterations_differ"] == 0, c
