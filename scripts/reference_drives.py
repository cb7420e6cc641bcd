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
                    warm-up;
  front             phase 4: the 40 frames of the front end through the
                    delta preset (FAST_GICP), GPS every frame, finish();
  front_ndt_omp     phase 11: the same frames with the odometry registration
                    REGISTRATION_PRESETS['hdl'] (NDT_OMP);
  front_fast_vgicp  phase 11: the same with FAST_VGICP;
  front_dense       phase 13: the same with neighbor_method='dense' and
                    cov_method='dense';
  lap_ndt_loops     phase 11: hdl_400 with HdlBackendConfig()'s NDT_OMP
                    backend registration over phase 7's lap, no warm-up;
  hdl_imu           phase 10: hdl_imu over phase 8's first IMU_FRAMES frames
                    with an identity orientation and gravity-only
                    acceleration before every scan, no warm-up;
  city_resumed      phase 13: phase 8's drive with buildings to RESUME_AT and
                    finish(), save_state, a fresh Pipeline, load_state, the
                    remaining frames, finish();
  multibag_voxel    phase 14: MultiBagOdometry over phase 4's prefiltered
                    frames, MB_BAGS bags (bag b from frame b), voxel
                    correspondences, MB_STEPS lockstep frames.
Per drive with a backend the file holds chip_smoke.drive_arrays: keyframe
stamps and poses after finish(), the keyframe poses after every update step
and the frames fed by then, every frame's odometry, chi2 (and LM iterations)
per step, loop edges, building vertices and their poses, ATE / t-RPE /
r-RPE (city_resumed: over both halves, and ``state.*`` the checkpoint
without its clouds, see resume_state); the front-end drives hold
chip_smoke.front_arrays (every frame's odometry, GN iterations and
convergence), multibag_voxel every bag's odometry and GN iterations at every
step. ``meta.*`` holds the JAX version, the threefry and x64 flags, the
commands, the frame parameters and the seconds each drive took. Recording
merges into --out: the drives not recorded keep their arrays. The whole
file takes ~60 min on 8 CPU cores.
"""

import argparse
import dataclasses
import importlib
import json
import os
import sys
import tempfile
import time
import types
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


def feed_all(pipe, frames, gts, imu=False):
    """chip_smoke.drive: GPS then the scan of every frame; with ``imu``,
    chip_smoke.hdl_drive's identity orientation and gravity-only
    acceleration between them."""
    for fr, gt in zip(frames, gts):
        pipe.on_gps(fr.stamp, *fr.gps)
        if imu:
            pipe.on_imu(fr.stamp, [1.0, 0.0, 0.0, 0.0],
                        linear_acceleration=[0.0, 0.0, 9.81])
        pipe.on_points(fr.stamp, fr.points, gt_pose=gt)


def timed_drive(pipe, frames, gts, warmup, stop=None, imu=False):
    """chip_smoke.timed_drive, serial: the warm-up frames, two update
    steps, the timers reset, the remaining frames, finish(); with ``stop``,
    the frames before frame ``stop`` and no finish()."""
    feed_all(pipe, frames[:warmup], gts[:warmup], imu)
    pipe.optimize()
    pipe.optimize()
    pipe.timer.reset()
    pipe.backend.timer.reset()
    feed_all(pipe, frames[warmup:stop], gts[warmup:stop], imu)
    if stop is None:
        pipe.finish()


def raycast_sequence(n_frames, scans=None, **kw):
    """io/lidar_sim.raycast_city_sequence(n_frames, speed=3.0, **kw) of the
    JAX package: (world, frames). With ``scans``, only the frames of those
    indices get their raycast scan (each scan draws from a seed of its own,
    after the trajectory and GPS are drawn), the others none."""
    from delta_graph_slam_tpu.io.kitti import synthetic_city_sequence
    from delta_graph_slam_tpu.io.lidar_sim import LidarModel, raycast_scan

    world, frames = synthetic_city_sequence(n_frames=n_frames, seed=0, speed=3.0,
                                            dt=0.1, **kw)
    for k, fr in enumerate(frames):
        fr.points = (raycast_scan(world, fr.gt_pose, 1.8, LidarModel(), seed=1000 + k)
                     if scans is None or k in scans else None)
    return world, frames


def lap_frames(scans=None):
    """chip_smoke.py phase 7's lap (frames, ground truth); ``scans`` as in
    raycast_sequence."""
    _, frames = raycast_sequence(cs.LAP_FRAMES, scans, trajectory="lap",
                                 turn_frames=20, gps_noise_std=0.5, gps_walk_std=0.15)
    return frames, rel_gt(frames)


def city_frames(n_frames=None, scans=None):
    """chip_smoke.city_frames: bench.py's city drive (world, frames, ground
    truth); with ``n_frames``, its first frames only (the same bytes: every
    frame draws from the generators in frame order); ``scans`` as in
    raycast_sequence."""
    world, frames = raycast_sequence(n_frames or cs.CITY_WARMUP + cs.CITY_FRAMES, scans,
                                     gps_noise_std=0.5, gps_walk_std=0.15)
    return world, frames, rel_gt(frames)


def front_frames(n_frames=None):
    """chip_smoke.run_slice's frames (phase 4), its first ``n_frames`` only
    when given: no ground truth is fed."""
    _, frames = raycast_sequence(n_frames or cs.N_FRAMES)
    return frames, [None] * len(frames)


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


def hdl(pkg, cfg, frames, gts, warmup, stop=None, imu=False, **pipe_kw):
    """chip_smoke.hdl_drive, serial: ``cfg`` a preset name or a
    PipelineConfig of package ``pkg``."""
    if isinstance(cfg, str):
        cfg = _mod(pkg, "config").get_preset(cfg)
    pipe = _mod(pkg, "pipeline.runner").Pipeline(cfg, **pipe_kw)
    cs.trace_drive(pipe)
    timed_drive(pipe, frames, gts, warmup, stop, imu)
    return pipe


def hdl_400(pkg, world, frames, gts, stop=None, **pipe_kw):
    return hdl(pkg, "hdl_400", frames, gts, cs.CITY_WARMUP, stop, **pipe_kw)


def lap_ndt_loops(pkg, frames, gts, stop=None, **pipe_kw):
    """Phase 11: hdl_400 with the nodelet's NDT_OMP backend registration
    (HdlBackendConfig().registration) validating the lap's loops."""
    cfg = _mod(pkg, "config").get_preset("hdl_400")
    reg = _mod(pkg, "models.hdl_backend").HdlBackendConfig().registration
    cfg = dataclasses.replace(cfg, hdl=dataclasses.replace(cfg.hdl, registration=reg))
    return hdl(pkg, cfg, frames, gts, 0, stop, **pipe_kw)


FRONT_DRIVES = ("front", "front_ndt_omp", "front_fast_vgicp", "front_dense")


def front_config(pkg, name):
    """The delta preset of a front-end drive: phase 4's (``front``), phase
    11's odometry registration heads, phase 13's 'dense' methods."""
    cfg = _mod(pkg, "config").get_preset("delta")
    presets = _mod(pkg, "register.config").REGISTRATION_PRESETS
    reg = {"front_ndt_omp": presets["hdl"],
           "front_fast_vgicp": dataclasses.replace(presets["hdl"], method="FAST_VGICP"),
           }.get(name)
    if reg is not None:
        return dataclasses.replace(cfg, odometry=dataclasses.replace(
            cfg.odometry, registration=reg))
    if name == "front_dense":
        return dataclasses.replace(
            cfg, prefiltering=dataclasses.replace(cfg.prefiltering, neighbor_method="dense"),
            odometry=dataclasses.replace(cfg.odometry, registration=dataclasses.replace(
                cfg.odometry.registration, cov_method="dense")))
    assert name == "front", name
    return cfg


def record_odometry(pipe):
    """Records, into ``pipe.front_odometry``, every frame's odometry pose, GN
    iterations and convergence (what chip_smoke.front_arrays reads from the
    port's OdometryFrame; the JAX package's frame carries no iteration
    count, so it is read from the fused status vector, index 17)."""
    odo = pipe.odometry
    out, its = [], [0]
    pipe.front_odometry = out
    frame_type = sys.modules[type(odo).__module__].OdometryFrame
    if "iterations" not in frame_type._fields:
        status = odo._status_step

        def counted_status(*a):
            vec = status(*a)
            its[0] = int(np.asarray(vec)[17])
            return vec

        odo._status_step = counted_status
    matching = odo.matching

    def recorded(*a, **kw):
        its[0] = 0
        frame = matching(*a, **kw)
        out.append(types.SimpleNamespace(
            pose=np.asarray(frame.pose, np.float64), converged=bool(frame.converged),
            iterations=int(getattr(frame, "iterations", its[0]))))
        return frame

    odo.matching = recorded


def front(pkg, name, frames, gts, stop=None, **pipe_kw):
    """chip_smoke.make_pipeline and drive: phase 4's frames (GPS every
    frame) through the front-end drive ``name``, then finish()."""
    cfg = front_config(pkg, name)
    pipe = _mod(pkg, "pipeline.runner").Pipeline(
        cfg, building_provider=_mod(pkg, "buildings").StaticProvider(cs.EMPTY_OSM),
        **pipe_kw)
    record_odometry(pipe)
    feed_all(pipe, frames[:stop], gts[:stop])
    if stop is None:
        pipe.finish()
    return pipe


def prefilter_stage(pkg, device=None):
    """The delta preset's PrefilteringStage of package ``pkg`` (on ``device``
    for the port)."""
    stage = _mod(pkg, "models.prefiltering").PrefilteringStage
    cfg = _mod(pkg, "config").get_preset("delta").prefiltering
    return stage(cfg) if device is None else stage(cfg, device)


def prefiltered(pkg, frames, device=None):
    """chip_smoke.prefiltered: the frames through the delta preset's
    prefilter."""
    stage = prefilter_stage(pkg, device)
    return [stage.process(fr.points) for fr in frames]


def multibag(pkg, clouds, n_steps=None):
    """chip_smoke.multibag_drive at B = MB_BAGS, voxel correspondences: bag
    b replays ``clouds`` from frame b. Returns {"odom": (steps, B, 4, 4),
    "iters": (steps, B)} of the steps after the first (the keyframes)."""
    cfg = _mod(pkg, "config").get_preset("delta").odometry
    reg = dataclasses.replace(cfg.registration, nn_method="voxel")
    mb = _mod(pkg, "parallel").MultiBagOdometry(
        reg, cs.MB_BAGS, keyframe_delta_trans=cfg.keyframe_delta_trans,
        keyframe_delta_angle=cfg.keyframe_delta_angle)
    align, its = mb._align_batched, []

    def counted(*a):
        res = align(*a)
        its.append(np.asarray(res.iterations.tolist(), np.int64))
        return res

    mb._align_batched = counted
    steps = [[clouds[k + b] for b in range(cs.MB_BAGS)]
             for k in range(n_steps or cs.MB_STEPS)]
    mb.process(steps[0])
    odom = [mb.process(step) for step in steps[1:]]
    return {"odom": np.stack(odom).astype(np.float64), "iters": np.stack(its)}


# the checkpoint's members that resume_state keeps (the clouds are the
# prefiltered scans of the keyframes' frames, rebuilt by write_checkpoint)
CLOUD_MEMBERS = ("kf_clouds", "kf_flat", "keyframe_points")


def resume_state(path, frames, prefilter):
    """The checkpoint save_state wrote at ``path`` (with its .graph.npz and
    .odom.npz) as plain arrays without its clouds: ``state.*``,
    ``state.graph.*`` and ``state.odom.*``, the buildings' ids as strings
    and their corners concatenated (``b_corner_counts``), and per keyframe
    (and the odometry keyframe) the index of the frame whose prefiltered
    scan it holds. ``prefilter(frame)`` gives that scan; every cloud is
    checked to be its valid points, so write_checkpoint rebuilds the same
    checkpoint from the frames."""
    stamps = np.array([fr.stamp for fr in frames])
    out = {}
    with np.load(path, allow_pickle=True) as z:
        state = dict(z)
    with np.load(str(path) + ".graph.npz") as z:
        out.update({f"state.graph.{k}": z[k] for k in z.files})
    with np.load(str(path) + ".odom.npz") as z:
        odom = dict(z)
    kf = np.searchsorted(stamps, state["kf_stamps"])
    odom_kf = int(np.searchsorted(stamps, odom["keyframe_stamp"]))
    scans = [(cloud, flat, *prefilter(frames[i]))
             for cloud, flat, i in zip(state["kf_clouds"], state["kf_flat"], kf)]
    if not (all(np.array_equal(c, c3) and np.array_equal(f, f2) for c, f, c3, f2 in scans)
            and np.array_equal(odom["keyframe_points"], prefilter(frames[odom_kf])[0])):
        raise RuntimeError("a checkpoint cloud is not its frame's prefiltered scan")
    out["state.kf_frames"] = kf.astype(np.int64)
    out["state.odom.keyframe_frame"] = np.int64(odom_kf)
    out.update({f"state.odom.{k}": v for k, v in odom.items() if k not in CLOUD_MEMBERS})
    if "b_ids" in state:
        out["state.b_ids"] = np.array([str(b) for b in state.pop("b_ids")], np.str_)
        corners = [np.asarray(c, np.float64).reshape(-1, 2) for c in state.pop("b_corners")]
        out["state.b_corner_counts"] = np.array([len(c) for c in corners], np.int64)
        out["state.b_corners"] = np.concatenate(corners or [np.zeros((0, 2))])
    out.update({f"state.{k}": v for k, v in state.items() if k not in CLOUD_MEMBERS})
    return out


def write_checkpoint(drive, frames, path, prefilter):
    """The checkpoint of ``drive`` (a city_resumed record of the reference
    file) as save_state's three files at ``path``, its clouds rebuilt from
    ``frames`` through ``prefilter`` (see resume_state)."""
    st = {k[len("state."):]: v for k, v in drive.items() if k.startswith("state.")}
    graph = {k[len("graph."):]: v for k, v in st.items() if k.startswith("graph.")}
    odom = {k[len("odom."):]: v for k, v in st.items() if k.startswith("odom.")}
    state = {k: v for k, v in st.items() if "." not in k and k != "kf_frames"}
    scans = [prefilter(frames[i]) for i in st["kf_frames"]]
    state["kf_clouds"] = np.array([s[0] for s in scans] + [None], object)[:-1]
    state["kf_flat"] = np.array([s[1] for s in scans] + [None], object)[:-1]
    if "b_ids" in state:
        ends = np.cumsum(st["b_corner_counts"])
        corners = [state["b_corners"][e - n:e] for e, n in zip(ends, st["b_corner_counts"])]
        state["b_ids"] = np.array(list(state["b_ids"]) + [None], object)[:-1]
        state["b_corners"] = np.array(corners + [None], object)[:-1]
        del state["b_corner_counts"]
    odom["keyframe_points"] = prefilter(frames[int(odom.pop("keyframe_frame"))])[0]
    np.savez_compressed(path, **state)
    np.savez_compressed(str(path) + ".graph.npz", **graph)
    np.savez_compressed(str(path) + ".odom.npz", **odom)


def valid_points(pkg, device=None):
    """prefilter(frame) for resume_state: the (filtered3d, filtered2d) valid
    points of the frame's scan, as save_state stores a keyframe's clouds."""
    stage = prefilter_stage(pkg, device)

    def host(cloud):
        pts, mask = (np.asarray(x.cpu() if hasattr(x, "cpu") else x)
                     for x in (cloud.points, cloud.mask))
        return pts[mask]

    def prefilter(fr):
        out = stage.process(fr.points)
        return host(out.filtered3d), host(out.filtered2d)

    return prefilter


def city_resumed(pkg, world, frames, gts, **pipe_kw):
    """chip_smoke.checkpoint_drive: phase 8's drive with buildings to
    RESUME_AT (GPS then points, no warm-up steps) and finish(); save_state,
    a fresh Pipeline, load_state at the prefilter's capacity, the remaining
    frames, finish(). The returned pipeline's trace holds both halves and
    its ``resume_state`` the checkpoint (resume_state)."""
    pipe = delta_pipeline(pkg, world.osm_xml(), pipe_kw)
    cs.trace_drive(pipe)
    feed_all(pipe, frames[:cs.RESUME_AT], gts[:cs.RESUME_AT])
    pipe.finish()
    resumed = delta_pipeline(pkg, world.osm_xml(), pipe_kw)
    with tempfile.TemporaryDirectory() as work:
        path = Path(work) / "state.npz"
        pipe.save_state(path)
        cap = resumed.cfg.prefiltering.out_capacity
        resumed.load_state(path, cloud_capacity=cap, flat_capacity=cap)
        resumed.resume_state = resume_state(path, frames, valid_points(
            pkg, pipe_kw.get("device")))
    cs.trace_resumed(resumed, pipe.drive_trace)
    feed_all(resumed, frames[cs.RESUME_AT:], gts[cs.RESUME_AT:])
    resumed.finish()
    return resumed


def run_drive(name, pkg="delta_graph_slam_tpu", frames=None, **pipe_kw):
    """Drive ``name`` of REFERENCE_DRIVES through package ``pkg``
    (``pipe_kw`` to its Pipeline, e.g. device="cpu" for the port) on
    ``frames`` (frames_for(name), built when None). Returns the pipeline,
    or multibag_voxel's arrays."""
    frames = frames or frames_for(name)
    if name in FRONT_DRIVES:
        return front(pkg, name, *frames, **pipe_kw)
    if name == "multibag_voxel":
        clouds = [out.filtered3d for out in prefiltered(pkg, frames[0],
                                                        pipe_kw.get("device"))]
        return multibag(pkg, clouds)
    if name.startswith("lap"):
        if name == "lap_ndt_loops":
            return lap_ndt_loops(pkg, *frames, **pipe_kw)
        return lap(pkg, *frames, loops_on=name == "lap", **pipe_kw)
    world, frames, gts = frames
    if name == "hdl_400":
        return hdl_400(pkg, world, frames, gts, **pipe_kw)
    if name == "hdl_imu":
        return hdl(pkg, "hdl_imu", frames[:cs.IMU_FRAMES], gts[:cs.IMU_FRAMES], 0,
                   imu=True, **pipe_kw)
    if name == "city_resumed":
        return city_resumed(pkg, world, frames, gts, **pipe_kw)
    return city(pkg, world, frames, gts, buildings=name == "city", **pipe_kw)



def frame_kind(name):
    """Which frames a drive takes: phase 4's, the lap or the city drive."""
    if name in FRONT_DRIVES or name == "multibag_voxel":
        return "front"
    return "lap" if name.startswith("lap") else "city"


def frames_for(name):
    return {"front": front_frames, "lap": lap_frames,
            "city": city_frames}[frame_kind(name)]()


def drive_record(name, driven):
    """The arrays of drive ``name`` in the reference file from what
    run_drive returned."""
    if name in FRONT_DRIVES:
        return cs.front_arrays(driven.front_odometry)
    if name == "multibag_voxel":
        return driven
    out = cs.drive_arrays(driven)
    out.update(getattr(driven, "resume_state", {}))
    return out


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default=str(ROOT / cs.REFERENCE_FILE))
    parser.add_argument("--only", nargs="+", choices=cs.REFERENCE_DRIVES,
                        help="record these drives only")
    args = parser.parse_args()

    import jax

    out = Path(args.out)
    arrays, meta = {}, {}
    if out.exists():      # merge: the drives not recorded keep their arrays
        with np.load(out) as z:
            arrays = {k: z[k] for k in z.files if not k.startswith("meta.")}
            meta = {k[len("meta."):]: z[k] for k in z.files if k.startswith("meta.")}
    t_all = time.perf_counter()
    seconds, frames = {}, {}
    for name in args.only or cs.REFERENCE_DRIVES:
        t0 = time.perf_counter()
        kind = frame_kind(name)
        if kind not in frames:
            frames[kind] = frames_for(name)
        record = drive_record(name, run_drive(name, frames=frames[kind]))
        seconds[name] = time.perf_counter() - t0
        arrays = {k: v for k, v in arrays.items() if not k.startswith(name + ".")}
        arrays.update({f"{name}.{k}": v for k, v in record.items()})
        print(f"{name}: " + summary(record) + f" ({seconds[name]:.1f} s)", flush=True)
    params = {k: getattr(cs, k) for k in ("LAP_FRAMES", "CITY_WARMUP", "CITY_FRAMES",
                                          "EMPTY_OSM", "N_FRAMES", "IMU_FRAMES",
                                          "RESUME_AT", "MB_BAGS", "MB_STEPS")}
    command = " ".join(["python3", "scripts/reference_drives.py"] + sys.argv[1:])
    recording = {"command": command, "drives": list(seconds),
                 "jax_version": jax.__version__, "seconds": time.perf_counter() - t_all}
    old = {k: str(meta[k]) for k in ("drive_seconds", "recordings") if k in meta}
    recordings = json.loads(old.get("recordings", "[]"))
    if not recordings and "command" in meta:      # the file's first recording
        recordings.append({"command": str(meta["command"]),
                           "drives": list(json.loads(old["drive_seconds"])),
                           "jax_version": str(meta["jax_version"]),
                           "seconds": float(meta["seconds"])})
    meta.update({
        "jax_version": np.array(jax.__version__),
        "threefry_partitionable": np.array(bool(jax.config.jax_threefry_partitionable)),
        "x64": np.array(bool(jax.config.jax_enable_x64)),
        "platform": np.array(jax.devices()[0].platform),
        "params": np.array(json.dumps(params)),
        "drive_seconds": np.array(json.dumps(
            json.loads(old.get("drive_seconds", "{}")) | seconds)),
        "recordings": np.array(json.dumps(recordings + [recording])),
    })
    meta.setdefault("command", np.array(command))
    meta.setdefault("seconds", np.array(recording["seconds"]))
    arrays.update({f"meta.{k}": v for k, v in meta.items()})
    out.parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out, **arrays)
    print(f"wrote {out} ({out.stat().st_size} bytes) in {recording['seconds']:.1f} s",
          flush=True)


def summary(record):
    """One line of a recorded drive."""
    if "kf_stamps" not in record:
        its = record["iters"]
        return (f"{len(record['odom'])} steps, GN iterations mean {its.mean():.2f}, last "
                f"pose {np.round(record['odom'][-1].reshape(-1, 4, 4)[0, :3, 3], 4)}")
    m = record["metrics"]
    return (f"{len(record['odom'])} frames, {len(record['kf_stamps'])} keyframes, "
            f"{len(record['cycle_frames'])} update steps, {len(record['loop_edges'])} "
            f"loop edges, {len(record['building_nodes'])} building vertices, ATE "
            f"{float(m[0])!r} m, t-RPE {float(m[1])!r} m, r-RPE {float(m[2])!r} rad")


if __name__ == "__main__":
    main()
