"""The port at the presets' full widths on the CPU, with its default random
stream (the reference's threefry stream, utils/prng.py), held to the JAX
package's own drives in tests/data/reference_drives.npz, which
scripts/reference_drives.py records from the JAX package on the CPU.
Both packages are driven by the same code (reference_drives.run_drive) over
the frames chip_smoke.py builds.

Tier 1: phase 8's building drive up to and including its first update step
after the warm-up. Slow: every whole drive of the file, with the bounds
chip_smoke.py holds the card to.
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

# the full-width front end on the CPU: 4 threads keep the tier-1 drive
# (31 frames and two update steps) near 75 s in one process (~110 s at 2)
torch.set_num_threads(4)

PORT = "delta_graph_slam_tpu_torch"


@pytest.fixture(scope="module")
def reference():
    drives, meta = cs.load_reference()
    assert str(meta["jax_version"]) and not bool(meta["x64"])
    assert bool(meta["threefry_partitionable"])
    return drives


def cycle_rows(d, counts, rows, i):
    """The rows of ragged per-step ``rows`` that step ``i`` recorded."""
    end = int(d[counts][:i + 1].sum())
    return d[rows][end - int(d[counts][i]):end]


def test_reference_file_is_small_and_complete(reference):
    assert (ROOT / cs.REFERENCE_FILE).stat().st_size < 1 << 20
    for name in cs.REFERENCE_DRIVES:
        d = reference[name]
        assert len(d["kf_stamps"]) >= 3 and np.isfinite(d["kf_poses"]).all()
        assert len(d["odom"]) == (cs.LAP_FRAMES if name.startswith("lap")
                                  else cs.CITY_WARMUP + cs.CITY_FRAMES)
        assert d["cycle_keyframes"].sum() == len(d["cycle_poses"])
    assert len(reference["lap"]["loop_edges"]) >= 1
    assert len(reference["city"]["building_nodes"]) >= 3


def test_city_drive_to_first_cycle_matches_reference(reference):
    """Phase 8's drive with buildings (delta preset, full widths) through
    its warm-up and its first update step after it: the same update steps,
    keyframe stamps, every frame's odometry, keyframe and building poses
    after the step, and chi2."""
    ref = reference["city"]
    i = int(np.flatnonzero(ref["cycle_frames"] > cs.CITY_WARMUP)[0])
    n_frames = int(ref["cycle_frames"][i])
    world, frames, gts = rd.city_frames(n_frames)
    pipe = rd.city(PORT, world, frames, gts, stop=n_frames, device="cpu")
    got = cs.drive_arrays(pipe)
    np.testing.assert_array_equal(got["cycle_frames"], ref["cycle_frames"][:i + 1])
    np.testing.assert_array_equal(got["cycle_keyframes"], ref["cycle_keyframes"][:i + 1])
    np.testing.assert_array_equal(got["kf_stamps"],
                                  ref["kf_stamps"][:int(ref["cycle_keyframes"][i])])
    np.testing.assert_array_equal(got["building_ids"], ref["building_ids"][:len(
        got["building_ids"])])
    assert len(got["building_ids"]) == int(ref["cycle_buildings"][i]) >= 3
    # every frame's odometry: float32 GICP in both packages, summed in other
    # orders, parts by up to 0.77 mm and 7.8e-5 in a rotation entry over
    # these frames (measured on the CPU); bounds ~2.5x that
    np.testing.assert_allclose(got["odom"][:, :3, 3], ref["odom"][:n_frames, :3, 3],
                               atol=2e-3)
    np.testing.assert_allclose(got["odom"][:, :3, :3], ref["odom"][:n_frames, :3, :3],
                               atol=2e-4)
    # keyframe and building poses after the step: measured 0.77 mm / 5.9e-5
    # rad (keyframes) and 0.29 mm / 1.9e-5 rad (buildings); bounds ~2.5x
    for counts, rows in (("cycle_keyframes", "cycle_poses"),
                         ("cycle_buildings", "cycle_building_poses")):
        g, r = cycle_rows(got, counts, rows, i), cycle_rows(ref, counts, rows, i)
        np.testing.assert_allclose(g[:, :2], r[:, :2], atol=2e-3)
        np.testing.assert_allclose(g[:, 2], r[:, 2], atol=2e-4)
    # chi2 of both levels, every step: level 1 measured 0.87% apart; level 0
    # is ~1e-16 in both (float64 noise at the GPS-fitted optimum), hence atol
    np.testing.assert_allclose(got["chi2"], ref["chi2"][:i + 1], rtol=2e-2, atol=1e-9)


@pytest.mark.slow
@pytest.mark.parametrize("name", cs.REFERENCE_DRIVES)
def test_whole_drive_matches_reference(reference, name):
    """A whole drive of the file against the reference, at chip_smoke.py's
    bounds (REF_POSITION_M, REF_YAW_RAD, REF_ATE_M): equal keyframe stamps
    and counts of loop edges and building vertices."""
    frames = rd.lap_frames() if name.startswith("lap") else rd.city_frames()
    pipe = rd.run_drive(name, PORT, frames=frames, device="cpu")
    c = cs.compare_drive(cs.drive_arrays(pipe), reference[name])
    print(f"{name}: " + ", ".join(f"{k} {v}" for k, v in c.items()))
    assert not cs.reference_failures(c)
