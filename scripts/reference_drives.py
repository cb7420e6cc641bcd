#!/usr/bin/env python3
"""Record the JAX package's own trajectories over the drives that
chip_smoke.py runs on the card, so that the port's drives can be held to
them at full width.

    python3 scripts/reference_drives.py [--out tests/data/reference_drives.npz]
                                        [--only DRIVE ...]

Runs the reference (delta_graph_slam_tpu) on the CPU, serially, with its
presets unchanged and x64 off (the package's default), over exactly the
frames chip_smoke.py builds (the JAX package's io/lidar_sim.py gives the
port's bytes) and in the same order of calls. ``run_drive`` takes the
package to drive, so tests/test_torch_reference_drives.py drives the port
through the same code. The drives:
  lap               phase 7: the 120-frame out-and-back lap, delta without
                    buildings, loop closure on (GPS then points, finish());
  lap_no_loops      the same lap with distance_thresh 0 (odometry only);
  city              phase 8: 10 warm-up frames, two update steps, 240 frames
                    of the city drive with its OSM buildings, finish();
  city_no_buildings the same frames with enable_buildings off;
  hdl_400           phase 10: hdl_400 over phase 8's frames, the same
                    warm-up.
Per drive the file holds chip_smoke.drive_arrays: keyframe stamps and poses
after finish(), the keyframe poses after every update step and the frames
fed by then, every frame's odometry, chi2 (and LM iterations) per step, loop
edges, building vertices and their poses, ATE / t-RPE / r-RPE; ``meta.*``
holds the JAX version, the threefry and x64 flags, the command, the frame
parameters and the seconds each drive took. Takes ~25-35 min on 8 CPU cores.
"""

import argparse
import dataclasses
import importlib
import json
import os
import sys
import time
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def rel_gt(frames):
    from delta_graph_slam_tpu.geom.host import se2_compose_np, se2_inverse_np

    g0 = se2_inverse_np(frames[0].gt_pose)
    return [se2_compose_np(g0, fr.gt_pose) for fr in frames]


def _mod(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def delta_pipeline(pkg, buildings_xml, pipe_kw, **over):
    cfg = _mod(pkg, "config").get_preset("delta")
    if over:
        cfg = dataclasses.replace(cfg, delta=dataclasses.replace(cfg.delta, **over))
    provider = _mod(pkg, "buildings").StaticProvider(buildings_xml)
    return _mod(pkg, "pipeline.runner").Pipeline(cfg, building_provider=provider,
                                                  **pipe_kw)


def feed_all(pipe, frames, gts):
    """chip_smoke.drive: GPS then the scan of every frame."""
    for fr, gt in zip(frames, gts):
        pipe.on_gps(fr.stamp, *fr.gps)
        pipe.on_points(fr.stamp, fr.points, gt_pose=gt)


def timed_drive(pipe, frames, gts, warmup, stop=None):
    """chip_smoke.timed_drive, serial: the warm-up frames, two update
    steps, the timers reset, the remaining frames, finish(); with ``stop``,
    the frames before frame ``stop`` and no finish()."""
    feed_all(pipe, frames[:warmup], gts[:warmup])
    pipe.optimize()
    pipe.optimize()
    pipe.timer.reset()
    pipe.backend.timer.reset()
    feed_all(pipe, frames[warmup:stop], gts[warmup:stop])
    if stop is None:
        pipe.finish()


def lap_frames():
    """chip_smoke.py phase 7's lap."""
    from delta_graph_slam_tpu.io.lidar_sim import raycast_city_sequence

    _, frames = raycast_city_sequence(n_frames=cs.LAP_FRAMES, trajectory="lap",
                                      turn_frames=20, speed=3.0, gps_noise_std=0.5,
                                      gps_walk_std=0.15)
    return frames, rel_gt(frames)


def city_frames(n_frames=None):
    """chip_smoke.city_frames: bench.py's city drive (world, frames, ground
    truth); with ``n_frames``, its first frames only (the same bytes: every
    frame draws from the generators in frame order)."""
    from delta_graph_slam_tpu.io.lidar_sim import raycast_city_sequence

    world, frames = raycast_city_sequence(
        n_frames=n_frames or cs.CITY_WARMUP + cs.CITY_FRAMES, speed=3.0,
        gps_noise_std=0.5, gps_walk_std=0.15)
    return world, frames, rel_gt(frames)


def lap(pkg, frames, gts, loops_on=True, **pipe_kw):
    over = dict(enable_buildings=False)
    if not loops_on:
        over["distance_thresh"] = 0.0
    pipe = delta_pipeline(pkg, cs.EMPTY_OSM, pipe_kw, **over)
    cs.trace_drive(pipe)
    feed_all(pipe, frames, gts)
    pipe.finish()
    return pipe


def city(pkg, world, frames, gts, buildings=True, stop=None, **pipe_kw):
    pipe = (delta_pipeline(pkg, world.osm_xml(), pipe_kw) if buildings
            else delta_pipeline(pkg, cs.EMPTY_OSM, pipe_kw, enable_buildings=False))
    cs.trace_drive(pipe)
    timed_drive(pipe, frames, gts, cs.CITY_WARMUP, stop)
    return pipe


def hdl_400(pkg, world, frames, gts, stop=None, **pipe_kw):
    cfg = _mod(pkg, "config").get_preset("hdl_400")
    pipe = _mod(pkg, "pipeline.runner").Pipeline(cfg, **pipe_kw)
    cs.trace_drive(pipe)
    timed_drive(pipe, frames, gts, cs.CITY_WARMUP, stop)
    return pipe


def run_drive(name, pkg="delta_graph_slam_tpu", frames=None, **pipe_kw):
    """Drive ``name`` of REFERENCE_DRIVES through package ``pkg``
    (``pipe_kw`` to its Pipeline, e.g. device="cpu" for the port) on
    ``frames`` (lap_frames() or city_frames(), built when None)."""
    if name.startswith("lap"):
        frames, gts = frames or lap_frames()
        return lap(pkg, frames, gts, loops_on=name == "lap", **pipe_kw)
    world, frames, gts = frames or city_frames()
    if name == "hdl_400":
        return hdl_400(pkg, world, frames, gts, **pipe_kw)
    return city(pkg, world, frames, gts, buildings=name == "city", **pipe_kw)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=str(ROOT / cs.REFERENCE_FILE))
    parser.add_argument("--only", nargs="+", choices=cs.REFERENCE_DRIVES,
                        help="record these drives only")
    args = parser.parse_args()

    import jax

    t_all = time.perf_counter()
    arrays, seconds, frames = {}, {}, {}
    for name in args.only or cs.REFERENCE_DRIVES:
        t0 = time.perf_counter()
        kind = "lap" if name.startswith("lap") else "city"
        if kind not in frames:
            frames[kind] = lap_frames() if kind == "lap" else city_frames()
        pipe = run_drive(name, frames=frames[kind])
        seconds[name] = time.perf_counter() - t0
        for k, v in cs.drive_arrays(pipe).items():
            arrays[f"{name}.{k}"] = v
        m = arrays[f"{name}.metrics"]
        print(f"{name}: {len(arrays[name + '.odom'])} frames, "
              f"{len(arrays[name + '.kf_stamps'])} keyframes, "
              f"{len(arrays[name + '.cycle_frames'])} update steps, "
              f"{len(arrays[name + '.loop_edges'])} loop edges, "
              f"{len(arrays[name + '.building_nodes'])} building vertices, ATE "
              f"{float(m[0])!r} m, t-RPE {float(m[1])!r} m, r-RPE {float(m[2])!r} rad "
              f"({seconds[name]:.1f} s)", flush=True)
    params = {k: getattr(cs, k) for k in ("LAP_FRAMES", "CITY_WARMUP", "CITY_FRAMES",
                                          "EMPTY_OSM")}
    meta = {
        "jax_version": np.array(jax.__version__),
        "threefry_partitionable": np.array(bool(jax.config.jax_threefry_partitionable)),
        "x64": np.array(bool(jax.config.jax_enable_x64)),
        "platform": np.array(jax.devices()[0].platform),
        "command": np.array(" ".join(["python3", "scripts/reference_drives.py"]
                                     + sys.argv[1:])),
        "params": np.array(json.dumps(params)),
        "drive_seconds": np.array(json.dumps(seconds)),
        "seconds": np.array(time.perf_counter() - t_all),
    }
    arrays.update({f"meta.{k}": v for k, v in meta.items()})
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, **arrays)
    print(f"wrote {out} ({out.stat().st_size} bytes) in {meta['seconds']:.1f} s",
          flush=True)


if __name__ == "__main__":
    main()
