"""The port's command line and host I/O against the JAX package, on the CPU:
bags (io/bag.py), the transform table (io/tf_table.py), the native host
I/O library (native/, built here with g++ from the port's own source), the
convert-kitti / convert-ford commands and ``run --device cpu``.
"""

import argparse
import dataclasses
import json
import struct
from pathlib import Path

import numpy as np
import pytest
import scipy.io
import torch

from delta_graph_slam_tpu import cli as r_cli
from delta_graph_slam_tpu import native as r_native
from delta_graph_slam_tpu.io.bag import Bag as RBag
from delta_graph_slam_tpu.io.bag import Message as RMessage
from delta_graph_slam_tpu.io.tf_table import TransformTable as RTable
from delta_graph_slam_tpu_torch import cli, native
from delta_graph_slam_tpu_torch.buildings import StaticProvider
from delta_graph_slam_tpu_torch.interop import config_from_reference_fields
from delta_graph_slam_tpu_torch.io.bag import Bag, BagPlayer, Message
from delta_graph_slam_tpu_torch.io.kitti import load_kitti_velodyne_bin
from delta_graph_slam_tpu_torch.io.lidar_sim import raycast_city_sequence
from delta_graph_slam_tpu_torch.io.pcd import load_pcd as py_load_pcd
from delta_graph_slam_tpu_torch.io.tf_table import TransformTable
from delta_graph_slam_tpu_torch.models.delta_backend import DeltaBackendConfig
from delta_graph_slam_tpu_torch.pipeline.flow import Watermark
from delta_graph_slam_tpu_torch.pipeline.runner import Pipeline
from test_torch_building_drive import _delta_config
from test_torch_runner import small_cfg

torch.set_num_threads(2)
RNG = np.random.default_rng(0)


def messages_of(bag):
    return [(m.stamp, m.topic, np.asarray(m.data)) for m in bag]


def assert_same_messages(a, b):
    assert [(s, t) for s, t, _ in a] == [(s, t) for s, t, _ in b]
    for (_, _, x), (_, _, y) in zip(a, b):
        np.testing.assert_array_equal(x, y)


def assert_same_npz(a, b):
    za, zb = np.load(a, allow_pickle=True), np.load(b, allow_pickle=True)
    assert sorted(za.files) == sorted(zb.files)
    for k in za.files:
        x, y = za[k], zb[k]
        assert x.shape == y.shape
        for u, v in zip(x.reshape(-1), y.reshape(-1)):
            np.testing.assert_array_equal(np.asarray(u), np.asarray(v))


# --------------------------------------------------------------------- bags

@pytest.mark.parametrize("writer", ["port", "reference"])
def test_bag_npz_interchanges(tmp_path, writer):
    """A bag written by either package loads in the other, message for
    message (the npz layout and its object arrays are the same)."""
    rows = [(0.1, "points", RNG.uniform(-1, 1, (50, 3)).astype(np.float32)),
            (0.15, "gps", np.array([49.0, 8.4, 110.0])),
            (0.2, "points", RNG.uniform(-1, 1, (70, 3)).astype(np.float32)),
            (0.25, "nmea", "$GPRMC,...")]
    W, Mw = (Bag, Message) if writer == "port" else (RBag, RMessage)
    R = RBag if writer == "port" else Bag
    W([Mw(*r) for r in rows]).save_npz(tmp_path / "b.npz")
    back = R.from_npz(tmp_path / "b.npz")
    assert back.topics() == ["gps", "nmea", "points"]
    assert_same_messages(messages_of(back), [(s, t, np.asarray(d)) for s, t, d in rows])


def test_bag_player_with_watermark():
    """tests/test_io.py:70: a consumer far ahead never blocks the player."""
    msgs = [Message(0.1 * k, "points", k) for k in range(5)]
    got = []
    wm = Watermark()
    wm.advertise("consumer", 100.0)
    BagPlayer(Bag(msgs), {"points": lambda m: got.append(m.data)}, watermark=wm,
              wait_timeout=1.0).play()
    assert got == [0, 1, 2, 3, 4]
    # a consumer behind the stamps holds a flow topic for wait_timeout, then
    # the player goes on; other topics pass without waiting
    wm.advertise("slow", 0.0)
    seen = []
    BagPlayer(Bag([Message(0.0, "gps", 0), Message(0.5, "points", 1)]),
              {"points": lambda m: seen.append(m.data),
               "gps": lambda m: seen.append(m.data)},
              watermark=wm, wait_timeout=0.05).play()
    assert seen == [0, 1]


# -------------------------------------------------------------- tf table

def test_transform_table_static_and_inverse():
    """tests/test_io.py:97 on both packages."""
    T = np.eye(4)
    T[:3, 3] = [1, 2, 3]
    T[:3, :3] = np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1]])
    for t in (TransformTable(), RTable()):
        t.set_static("base", "lidar", T)
        np.testing.assert_allclose(t.lookup("base", "lidar"), T)
        np.testing.assert_allclose(t.lookup("lidar", "base"), np.linalg.inv(T))
        assert t.can_transform("base", "lidar") and t.can_transform("x", "x")
        with pytest.raises(KeyError):
            t.lookup("base", "nonexistent")


def test_transform_table_dynamic_nearest():
    """tests/test_io.py:110, and the inverse of a dynamic frame, on both."""
    tables = (TransformTable(), RTable())
    for t in tables:
        for k in range(5):
            T = np.eye(4)
            T[0, 3] = k
            t.add_dynamic("map", "base", float(k), T)
    for stamp in (2.2, 2.8, -1.0, 9.0, 2.5):
        got, want = (t.lookup("map", "base", stamp) for t in tables)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(tables[0].lookup("base", "map", stamp),
                                      tables[1].lookup("base", "map", stamp))
    assert tables[0].lookup("map", "base", 2.2)[0, 3] == 2.0
    assert tables[0].lookup("map", "base", 2.8)[0, 3] == 3.0


# ------------------------------------------------------------------- libpcio

@pytest.fixture(scope="module")
def pcio():
    """The port's libpcio, built with g++ from native/pointcloud_io.cpp into
    _build/; a silent Python fall-back would not pass this fixture."""
    lib = native.load_library(build=True)
    assert lib is not None
    assert Path(lib._name) == native.library_path()
    assert native.library_path().parent == native.BUILD_DIR
    assert native.library_path().parent.name == "_build"
    assert r_native.load_library(build=True) is not None
    return lib


def test_pcio_pcd_matches_reference(pcio, tmp_path):
    pts = RNG.uniform(-10, 10, (1234, 3)).astype(np.float32)
    native.save_pcd(tmp_path / "p.pcd", pts)
    r_native.save_pcd(str(tmp_path / "r.pcd"), pts)
    assert (tmp_path / "p.pcd").read_bytes() == (tmp_path / "r.pcd").read_bytes()
    for path in ("p.pcd", "r.pcd"):
        np.testing.assert_array_equal(native.load_pcd(tmp_path / path), pts)
        np.testing.assert_array_equal(py_load_pcd(tmp_path / path), pts)
    # a layout other than x y z goes to the Python reader, as in the reference
    with open(tmp_path / "i.pcd", "w") as f:
        f.write("VERSION 0.7\nFIELDS x y z intensity\nSIZE 4 4 4 4\nTYPE F F F F\n"
                "COUNT 1 1 1 1\nWIDTH 2\nHEIGHT 1\nPOINTS 2\nDATA ascii\n"
                "1 2 3 9\n4 5 6 9\n")
    np.testing.assert_array_equal(native.load_pcd(tmp_path / "i.pcd"),
                                  r_native.load_pcd(str(tmp_path / "i.pcd")))


def test_pcio_kitti_bin_and_voxel_thin_match_reference(pcio, tmp_path):
    raw = RNG.uniform(-50, 50, (500, 4)).astype(np.float32)
    raw.tofile(tmp_path / "scan.bin")
    got = native.load_kitti_bin(tmp_path / "scan.bin")
    np.testing.assert_array_equal(got, raw[:, :3])
    np.testing.assert_array_equal(got, r_native.load_kitti_bin(str(tmp_path / "scan.bin")))
    np.testing.assert_array_equal(load_kitti_velodyne_bin(tmp_path / "scan.bin"), raw[:, :3])
    pts = RNG.uniform(-5, 5, (2000, 3)).astype(np.float32)
    # the same hash walk and float64 sums: bitwise the reference's output
    np.testing.assert_array_equal(native.voxel_thin(pts, 0.7),
                                  r_native.voxel_thin(pts, 0.7))


def test_pcio_spool_interchanges(pcio, tmp_path):
    scans = [RNG.uniform(-1, 1, (n, 3)).astype(np.float32) for n in (100, 0, 333)]
    for W, R, name in ((native.ScanSpool, r_native.ScanSpool, "p.spool"),
                       (r_native.ScanSpool, native.ScanSpool, "r.spool")):
        w = W(str(tmp_path / name), "w")
        for i, s in enumerate(scans):
            w.append(10.0 + i, s)
        w.close()
        r = R(str(tmp_path / name), "r")
        assert len(r) == 3
        for i, s in enumerate(scans):
            assert r.stamp(i) == 10.0 + i
            np.testing.assert_array_equal(r.read(i), s)
        r.close()
    assert (tmp_path / "p.spool").read_bytes() == (tmp_path / "r.spool").read_bytes()
    r = native.ScanSpool(str(tmp_path / "p.spool"))
    with pytest.raises(IndexError):
        r.read(3)
    r.close()


# ---------------------------------------------------------- convert commands

def test_convert_kitti_matches_reference(tmp_path):
    vel = tmp_path / "velodyne"
    vel.mkdir()
    for k in range(3):
        RNG.uniform(-30, 30, (200 + k, 4)).astype(np.float32).tofile(vel / f"{k:010d}.bin")
    (tmp_path / "times.txt").write_text("0.0\n0.1\n0.2\n")
    for stamps in (None, str(tmp_path / "times.txt")):
        assert cli.main(["convert-kitti", "--velodyne-dir", str(vel),
                         "--out", str(tmp_path / "p.npz")]
                        + (["--timestamps", stamps] if stamps else [])) == 0
        r_cli._cmd_convert_kitti(argparse.Namespace(
            velodyne_dir=str(vel), timestamps=stamps, out=str(tmp_path / "r.npz")))
        assert_same_npz(tmp_path / "p.npz", tmp_path / "r.npz")
    assert len(Bag.from_npz(tmp_path / "p.npz")) == 3


def test_convert_ford_matches_reference(tmp_path):
    """Scan*.mat files written with scipy.io.savemat and a packed binary
    GPS.log (one record near lat 0, which both skip)."""
    (tmp_path / "SCANS").mkdir()
    for k in range(2):
        xyz = RNG.uniform(-20, 20, (3, 150 + k))
        scipy.io.savemat(tmp_path / "SCANS" / f"Scan{k + 1:04d}.mat", {
            "SCAN": {"XYZ": xyz, "timestamp_laser": np.array([[1_000_000 + 100_000 * k]])}})
    with open(tmp_path / "GPS.log", "wb") as f:
        for t_us, lat in ((1_010_000, 42.3), (1_050_000, 0.0), (1_110_000, 42.30001)):
            f.write(struct.pack("qddd", t_us, 0.0, 0.0, 0.0))
            f.write(struct.pack("dddd", lat, -83.2, 180.0, 0.5))
            f.write(np.zeros(16).tobytes())
    assert cli.main(["convert-ford", "--src-dir", str(tmp_path),
                     "--out", str(tmp_path / "p.npz")]) == 0
    r_cli._cmd_convert_ford(argparse.Namespace(src_dir=str(tmp_path),
                                               out=str(tmp_path / "r.npz")))
    assert_same_npz(tmp_path / "p.npz", tmp_path / "r.npz")
    assert [m.topic for m in Bag.from_npz(tmp_path / "p.npz")] == [
        "points", "gps", "points", "gps"]


# ------------------------------------------------------------------ cli run

N_FRAMES = 16


def small_building_cfg():
    """tests/test_torch_runner.py's small pipeline with the building path of
    tests/test_torch_building_drive.py (its small line matcher)."""
    delta = config_from_reference_fields(dataclasses.asdict(_delta_config()),
                                         DeltaBackendConfig)
    cfg = small_cfg()
    return dataclasses.replace(cfg, delta=dataclasses.replace(
        cfg.delta, enable_buildings=True, scanmatcher=delta.scanmatcher))


@pytest.fixture(scope="module")
def drive_bag(tmp_path_factory):
    """A recorded raycast city drive: points and gps topics (each GPS stamp
    1 ms before its scan, so the two topics never share a stamp) and the
    city's OSM XML."""
    world, frames = raycast_city_sequence(n_frames=N_FRAMES, speed=3.0)
    d = tmp_path_factory.mktemp("drive")
    msgs = []
    for fr in frames:
        msgs.append(Message(fr.stamp - 1e-3, "gps", np.asarray(fr.gps, float)))
        msgs.append(Message(fr.stamp, "points", fr.points))
    Bag(msgs).save_npz(d / "drive.npz")
    (d / "city.osm").write_text(world.osm_xml())
    return d


def test_cli_run_matches_a_direct_pipeline_drive(drive_bag, tmp_path, monkeypatch, capsys):
    cfg = small_building_cfg()
    monkeypatch.setattr(cli, "get_preset", lambda name: cfg)
    out = tmp_path / "out"
    rc = cli.main(["run", "--preset", "delta", "--bag", str(drive_bag / "drive.npz"),
                   "--osm-file", str(drive_bag / "city.osm"), "--device", "cpu",
                   "--save-map", str(out), "--dump-graph", str(out),
                   "--save-viz", str(out), "--eval", "--resolution", "0.2"])
    assert rc == 0
    stdout = capsys.readouterr().out
    summary = json.loads(stdout[: stdout.index("\n}\n") + 2])
    for name in ("map.pcd", "b_map.pcd", "aligned_b_map.pcd", "graph.g2o", "graph.npz",
                 "markers.json", "markers.svg"):
        assert (out / name).stat().st_size > 0, name
    assert summary["frames"] == N_FRAMES and "prefiltering" in summary["timing"]
    markers = json.loads((out / "markers.json").read_text())
    assert len(markers["keyframe_nodes"]) == summary["keyframes"] >= 3
    assert len(markers["building_nodes"]) >= 1

    # the same messages in the same order through Pipeline directly
    pipe = Pipeline(cfg, building_provider=StaticProvider(
        (drive_bag / "city.osm").read_text()), device="cpu")
    for m in Bag.from_npz(drive_bag / "drive.npz"):
        if m.topic == "gps":
            pipe.on_gps(m.stamp, *np.asarray(m.data).tolist())
        else:
            pipe.on_points(m.stamp, np.asarray(m.data))
    pipe.finish()
    assert len(pipe.backend.keyframes) == summary["keyframes"]
    np.testing.assert_array_equal(np.asarray(markers["keyframe_nodes"]),
                                  np.stack([k.estimate(pipe.backend.poses)[:2]
                                            for k in pipe.backend.keyframes]))


def test_cli_errors_return_1(tmp_path, capsys):
    assert cli.main(["run", "--preset", "nope", "--synthetic", "2",
                     "--device", "cpu"]) == 1
    assert "nope" in capsys.readouterr().err
    assert cli.main(["run", "--bag", str(tmp_path / "missing.npz"),
                     "--device", "cpu"]) == 1
    assert cli.main(["run", "--device", "cpu"]) == 2      # nothing to replay


def test_cli_default_device_is_the_card(tmp_path):
    """Without --device the run asks for the card; without one it raises
    (utils/device.py:resolve_device) and never drops to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    Bag([Message(0.0, "points", np.zeros((4, 3), np.float32))]).save_npz(tmp_path / "b.npz")
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["run", "--bag", str(tmp_path / "b.npz")])
