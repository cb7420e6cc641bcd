"""The port's hdl drives that chip_smoke.py runs beside hdl_400, at the
presets' full widths on the CPU, held to the JAX package's drives of the
same frames in tests/data/reference_drives.npz (recorded by
scripts/reference_drives.py): phase 10's hdl_imu (an orientation and a
gravity-only acceleration before every scan) and phase 11's hdl_400 with
the nodelet's NDT_OMP backend registration over the lap. Tier 1 drives a
prefix of each, before their first update step (floor detection costs
~2 s a frame at full width on an 8-core CPU and the first update step comes
after 31 frames); the whole drives, with their IMU edges and NDT-validated
loops, are slow cases of tests/test_torch_reference_drives.py.
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
PREFIX = 10


@pytest.fixture(scope="module")
def reference():
    return cs.load_reference()[0]


def traced_odometry(pipe):
    return {"odom": np.stack(pipe.drive_trace["odom"])}


def test_hdl_imu_prefix_matches_reference(reference):
    _, frames, gts = rd.city_frames(PREFIX)
    pipe = rd.hdl(PORT, "hdl_imu", frames, gts, 0, stop=PREFIX, imu=True, device="cpu")
    assert not pipe.drive_trace["cycles"]
    c = cs.compare_odometry(traced_odometry(pipe),
                            {"odom": reference["hdl_imu"]["odom"][:PREFIX]})
    # measured 0.45 mm / 3.7e-5 rad on the CPU (frame 1, as phase 4's front
    # end: FAST_GICP in both); bounds ~4x
    assert c["position_gap"] <= 2e-3 and c["rotation_gap"] <= 2e-4, c


def test_lap_ndt_loops_prefix_matches_reference(reference):
    frames, gts = rd.lap_frames(scans=range(PREFIX))
    pipe = rd.lap_ndt_loops(PORT, frames, gts, stop=PREFIX, device="cpu")
    assert not pipe.drive_trace["cycles"]
    c = cs.compare_odometry(traced_odometry(pipe),
                            {"odom": reference["lap_ndt_loops"]["odom"][:PREFIX]})
    # measured 0.46 mm / 3.3e-5 rad on the CPU (frame 3); bounds ~4x
    assert c["position_gap"] <= 2e-3 and c["rotation_gap"] <= 2e-4, c
