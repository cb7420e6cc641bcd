"""Command-line driver: replay datasets through the pipeline presets.

The roslaunch-equivalent entry point, the counterpart of the JAX package's
cli.py:

  python -m delta_graph_slam_tpu_torch.cli run --preset delta --synthetic 20 \
      --save-map out --eval --dump-graph out --save-viz out
  python -m delta_graph_slam_tpu_torch.cli run --preset delta --bag scans.npz \
      --osm-file city.osm
  python -m delta_graph_slam_tpu_torch.cli convert-kitti --velodyne-dir ... --out bag.npz
  python -m delta_graph_slam_tpu_torch.cli convert-ford --src-dir ... --out bag.npz

Two differences from the reference's command line:
- ``run`` takes ``--device`` (default ``cuda``, the card). Without a card
  the default raises (utils/device.py:resolve_device); it never drops to
  the CPU. ``--device cpu`` runs the plain CPU path.
- There is no compiled-program cache to enable (the reference's
  ``enable_persistent_cache`` keeps XLA programs across invocations).
And, as everywhere in the port, a delta run needs its building provider
named: ``--synthetic`` brings its world's OSM data, ``--bag`` needs
``--osm-file``; the reference would query the public Overpass server.
"""

import argparse
import glob
import json
import os
import re
import struct
import sys
import time

import numpy as np

from .buildings import FileProvider, StaticProvider
from .config import get_preset
from .geom.host import se2_compose_np, se2_inverse_np
from .io.bag import Bag, Message
from .io.kitti import synthetic_city_sequence
from .native import load_kitti_bin
from .pipeline.runner import Pipeline
from .utils.device import DEFAULT_DEVICE
from .utils.markers import save_viz


def _play_frames(pipe, frames):
    """Synthetic frames with ground truth anchored at the first frame (the
    reference harvests gt from tf relative to the run start, delta:172-195);
    one progress line a frame on stderr."""
    g0_inv = se2_inverse_np(np.asarray(frames[0].gt_pose, float))
    t_run0 = time.perf_counter()
    for i, fr in enumerate(frames):
        gt = se2_compose_np(g0_inv, np.asarray(fr.gt_pose, float))
        pipe.on_gps(fr.stamp, *fr.gps)
        t0 = time.perf_counter()
        pipe.on_points(fr.stamp, fr.points, gt_pose=gt)
        print(f"frame {i + 1}/{len(frames)}  "
              f"{time.perf_counter() - t0:7.2f}s  "
              f"(total {time.perf_counter() - t_run0:7.1f}s)",
              file=sys.stderr, flush=True)


def _play_bag(pipe, bag):
    for msg in bag:
        if msg.topic == "points":
            pipe.on_points(msg.stamp, np.asarray(msg.data))
        elif msg.topic == "gps":
            lat, lon, *alt = np.asarray(msg.data).tolist()
            pipe.on_gps(msg.stamp, lat, lon, alt[0] if alt else 0.0)
        elif msg.topic == "imu_quat":
            pipe.on_imu(msg.stamp, np.asarray(msg.data))
        elif msg.topic == "nmea":
            pipe.on_nmea(msg.stamp, str(msg.data))


def _cmd_run(args):
    cfg = get_preset(args.preset)
    if args.synthetic:
        world, frames = synthetic_city_sequence(n_frames=args.synthetic)
        provider = StaticProvider(world.osm_xml())
    elif args.bag:
        bag = Bag.from_npz(args.bag)
        provider = FileProvider(args.osm_file) if args.osm_file else None
    else:
        print("need --synthetic N or --bag file", file=sys.stderr)
        return 2

    pipe = Pipeline(cfg, building_provider=provider, device=args.device)
    if args.synthetic:
        _play_frames(pipe, frames)
    else:
        _play_bag(pipe, bag)
    pipe.finish()
    print(json.dumps({
        "frames": pipe.frames_processed,
        "keyframes": len(pipe.backend.keyframes),
        "timing": pipe.timing_summary(),
    }, indent=2))
    if args.eval:
        print(json.dumps({"metrics": pipe.evaluate()}, indent=2))
    if args.save_map:
        ok = pipe.save_map(args.save_map, resolution=args.resolution)
        print(f"save_map -> {args.save_map}: {ok}")
    if args.dump_graph:
        pipe.backend.dump_graph(args.dump_graph)
        print(f"dump_graph -> {args.dump_graph}")
    if args.save_viz and hasattr(pipe.backend, "create_marker_array"):
        png = save_viz(pipe.backend.create_marker_array(), args.save_viz)
        print(f"save_viz -> {args.save_viz} (png={bool(png)})")
    return 0


def _cmd_convert_kitti(args):
    """KITTI raw velodyne dir (+ optional timestamps) -> Bag npz (ford2bag.py's
    role for the container format)."""
    files = sorted(glob.glob(os.path.join(args.velodyne_dir, "*.bin")))
    stamps = None
    if args.timestamps and os.path.exists(args.timestamps):
        with open(args.timestamps) as f:
            stamps = [float(i) for i, _ in enumerate(f)]
    msgs = [Message(stamps[k] if stamps else k * 0.1, "points", load_kitti_bin(path))
            for k, path in enumerate(files)]
    Bag(msgs).save_npz(args.out)
    print(f"wrote {len(msgs)} scans -> {args.out}")
    return 0


def _cmd_convert_ford(args):
    """Ford IJRR dataset -> Bag npz (the reference's ford2bag.py role:
    SCANS/Scan*.mat velodyne clouds + binary GPS.log fixes)."""
    import scipy.io

    msgs = []
    scans = sorted(
        f for f in glob.glob(os.path.join(args.src_dir, "SCANS", "Scan*.mat"))
        if re.match(r"Scan[0-9]*\.mat$", os.path.basename(f))
    )
    for path in scans:
        m = scipy.io.loadmat(path)
        xyz = np.transpose(m["SCAN"]["XYZ"][0][0]).astype(np.float32)
        stamp = float(m["SCAN"]["timestamp_laser"][0][0][0][0]) * 1e-6
        msgs.append(Message(stamp, "points", xyz))
    gps_log = os.path.join(args.src_dir, "GPS.log")
    if os.path.exists(gps_log):
        with open(gps_log, "rb") as f:
            while True:
                head = f.read(8 * 4)
                if len(head) < 32:
                    break
                t_us = struct.unpack("qddd", head)[0]
                lat, lon, el, _theta = struct.unpack("dddd", f.read(8 * 4))
                f.read(8 * 16)  # covariance
                if abs(lat) < 1e-1:
                    continue
                msgs.append(Message(t_us * 1e-6, "gps", np.array([lat, lon, el])))
    Bag(msgs).save_npz(args.out)
    print(f"wrote {len(msgs)} messages -> {args.out}")
    return 0


def main(argv=None):
    p = argparse.ArgumentParser(prog="delta_graph_slam_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="replay a dataset through a preset")
    r.add_argument("--preset", default="delta")
    r.add_argument("--synthetic", type=int, default=0,
                   help="generate N synthetic city frames")
    r.add_argument("--bag", help="Bag npz path")
    r.add_argument("--osm-file", help="offline OSM XML for buildings")
    r.add_argument("--save-map", help="output directory for map.pcd")
    r.add_argument("--resolution", type=float, default=0.05)
    r.add_argument("--eval", action="store_true", help="print ATE/RPE")
    r.add_argument("--dump-graph", help="write g2o text + npz checkpoint")
    r.add_argument("--save-viz",
                   help="write markers.{json,svg,png} (rviz stand-in)")
    r.add_argument("--device", default=DEFAULT_DEVICE,
                   help="torch device of every stage (default: the card)")
    r.set_defaults(fn=_cmd_run)

    c = sub.add_parser("convert-kitti", help="KITTI raw -> bag npz")
    c.add_argument("--velodyne-dir", required=True)
    c.add_argument("--timestamps")
    c.add_argument("--out", required=True)
    c.set_defaults(fn=_cmd_convert_kitti)

    fd = sub.add_parser("convert-ford", help="Ford IJRR dataset -> bag npz")
    fd.add_argument("--src-dir", required=True,
                    help="directory containing SCANS/ and GPS.log")
    fd.add_argument("--out", required=True)
    fd.set_defaults(fn=_cmd_convert_ford)

    args = p.parse_args(argv)
    try:
        return args.fn(args)
    except (KeyError, FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
