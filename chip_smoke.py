#!/usr/bin/env python3
"""Smoke run of the PyTorch port (delta_graph_slam_tpu_torch) on one CUDA card.

    python3 chip_smoke.py [--out DIR]

Phases, each of which fails the run (non-zero exit, no result line):
  1. device: a CUDA card must be present; prints its nvidia-smi name and
     power limit;
  2. build: compiles csrc/nn1.cu with nvcc for sm_90a into the package's
     git-ignored _build/ directory;
  3. kernel vs plain: the 1-NN kernel against its plain PyTorch version
     (ops/knn.py:nn_1_reference) on the card, at the fitness shape
     32768 x 32768 (28000 x 27500 valid), at ragged, single-query,
     self-excluding and target-less shapes, and on duplicated targets whose
     equal minima fall in different slices and tiles (indices exact); the
     fitness case three times, bitwise equal; at the fitness shape the
     kernel, the plain version and torch.cdist(...).min(1) (a yardstick the
     port never calls) timed with CUDA events beside the FP32 bound and the
     SM clock;
  4. the front end: 40 raycast frames through Pipeline(get_preset('delta'))
     on the card at full capacity, GPS fed every frame, then finish(), run
     twice: the odometry poses of the two runs must be bitwise equal; the
     second run checks the odometry edges, the kernel launch count,
     convergence and drift; then the voxel sums of one scan (the run-wise
     segment_sum against the float index_add_ it replaced) timed, five
     runs each, the segment sum unchanged over them; the odometry is held
     to the reference's drive of the same frames (``front``): every
     frame's position within 2 cm and its rotation within 1e-3 rad, the
     first frame that parts by more than 1 mm and the GN iteration counts
     that differ printed;
  5. small input: the same pipeline at a small size on the card and through
     the plain CPU path, which must agree;
  6. graph solve: the 4096-node two-lap pose graph of bench.py, solved by
     optimize_se2 (chain backend) on the card twice (bit-identical chi2 and
     iteration counts) and held against a float64 robust LM on the host
     (scipy SuperLU); ms per LM iteration by the marginal protocol;
  7. backend drive: a 120-frame out-and-back raycast lap through the
     delta preset without buildings (GPS every frame, loop closure on):
     needs a loop edge validated through the nn1 kernel, finite chi2 on
     every cycle and ATE <= 1.0 m; the same drive with loop closure off
     is printed beside it; both drives are held to the JAX package's own
     drives of the same frames (REFERENCE_FILE, written on the CPU by
     scripts/reference_drives.py): keyframe stamps, loop edges (vertex
     pairs) and building vertices (ids) equal, |ATE - ATE of the reference| <=
     5 mm, every keyframe within 2 cm and 1e-3 rad; each prints its largest
     keyframe position and yaw gaps with their keyframes, the first frame
     whose odometry parts by more than 1 mm, and both ATEs;
  8. buildings: first the reference's random stream on the card
     (utils/prng.py): one keyframe's line draws and one floor draw bitwise
     equal to the CPU's, timed, their CUDA kernels counted; then the delta
     preset with OSM buildings on (RANSAC lines,
     align_global per keyframe, keyframe<->building edges, global priors,
     the de-overlap loop, save_map), 10 warm-up frames then 240 timed
     raycast frames of bench.py's city drive (GPS 0.5 m noise, 0.15 m/frame
     walk), then finish(); needs >= 3 building vertices, >= 1
     keyframe<->building edge, >= 1 global prior, align_global on every
     keyframe with buildings in range, finite chi2 on every cycle, <= 15
     de-overlap rounds a cycle, ATE <= 1.0 m and three non-empty PCD
     files; the drive again on the same frames, whose keyframe poses,
     odometry, estimated_odom, chi2 per cycle and ATE must be bitwise
     equal to the first; the same frames without buildings are printed
     beside it; the first drive and the no-buildings drive are held to the
     reference's as in phase 7;
  9. SE3 graph solve: the 4096-node hdl graph of bench.py (two laps, Huber
     loops every 100 nodes, one floor-plane hub with an se3plane edge every
     4th keyframe, one xyz prior), solved by optimize_se3 (chain backend:
     BCR + hub elimination, float64) on the card twice (bitwise-equal
     state, chi2 and iteration count) and held against a float64 robust LM
     on the host (scipy SuperLU): the card's chi2 must not exceed 1.02 x
     the host's; one chain_hub_solve step against a float64 dense solve of
     the same system; ms and kernel launches per LM iteration; then the
     same graph for SE3_CAPTURE_ITERS iterations (early exits off) with
     every LM iteration eager and with the iteration captured once as a
     CUDA graph and replayed: bitwise-equal state, chi2 and lambda; ms and
     kernels an iteration both ways;
 10. hdl drive: Pipeline(get_preset('hdl_400')) over phase 8's frames (GPS
     fed, which hdl_400 leaves off), twice: floor coefficients on >= 90 %
     of frames, the floor-plane vertex, >= 1 se3plane edge a keyframe, se3
     odometry edges = keyframes - 1 (+ the anchor edge), ATE <= 1.0 m,
     finite poses, nn1 launched, map.pcd written, graph.g2o read back with
     the same vertex and edge counts; whether the two drives' keyframe
     poses and chi2 are bitwise equal is printed and recorded; the first
     drive is held to the reference's as in phase 7; then 60
     frames through hdl_imu with identity orientation and gravity-only
     acceleration: quat and vec edges >= keyframes - 1, the drive held to
     the reference's (``hdl_imu``) as in phase 7;
 11. registration heads: phase 4's 40 frames with the odometry
     registration set to REGISTRATION_PRESETS['hdl'] (NDT_OMP, resolution
     1.0, DIRECT7) and to FAST_VGICP at resolution 1.0, each twice: >= 90 %
     of frames converged and the two runs bitwise equal; drift <= 5 % of
     the path for FAST_VGICP, while NDT_OMP's drift is printed and not held
     (on this drive the reference's NDT does not track frame to keyframe:
     tests/test_torch_voxel_heads.py); odometry ms and GN iterations a frame
     beside FAST_GICP's from phase 4; both held to the reference's drives
     (``front_ndt_omp``, ``front_fast_vgicp``) as in phase 4; then hdl_400
     with HdlBackendConfig()'s NDT_OMP backend registration over phase 7's
     lap: >= 1 loop candidate aligned through NDT, candidates and loops
     accepted printed, the drive held to the reference's
     (``lap_ndt_loops``) as in phase 7;
 12. threaded runner: phase 8's building drive and phase 10's hdl_400
     drive through Pipeline(..., threaded=True): no worker error, finish()
     returns, keyframe stamps and the odometry of every frame bitwise equal
     to the serial drive of the same phase (the largest odometry gap
     printed), ATE <= 1.0 m; frames/s to the last on_points return and to
     finish(), optimization_step ms a call and calls, and the lock_wait.*
     times printed beside the serial drive's;
 13. host runtime: the native host I/O library built with g++ from
     native/pointcloud_io.cpp into _build/ (its loaded path checked), a
     131072-point PCD round trip, phase 4's frames as KITTI .bin files and
     a scan spool, bitwise; the first 120 frames of phase 8's drive recorded
     to a bag (points and gps topics) with the city's OSM XML in a file,
     replayed through ``cli.main(["run", ...])`` on the card with
     --save-map, --dump-graph, --save-viz and --eval (rc 0, every file
     written, keyframes and final poses bitwise equal to a Pipeline drive of
     the same messages), and convert-kitti on 8 of the .bin files; phase 8's
     drive cut after 130 frames: Pipeline.save_state, a fresh Pipeline,
     load_state (poses within 1e-6 m), the remaining 120 frames with a 10 Hz
     Map2OdomPublisher (map->odom equal to the lifted trans_odom2map, ATE
     <= 1.0 m, printed beside phase 8's), both halves held to the
     reference's drive of the same calls (``city_resumed``) as in phase 7,
     building ids and loop edges equal; radius_moments at 32768 x 32768
     (phase 4's first scan, r 0.8 m, chunk 4096) on the card against the
     port's plain CPU run (counts equal away from r^2, means and
     covariances within 1e-5), then phase 4's frames with
     neighbor_method='dense' and cov_method='dense' twice (>= 90 %
     converged, drift <= 5 % of the path, odometry bitwise equal, held to
     the reference's ``front_dense`` as in phase 4), frames/s and ms/frame
     beside phase 4's voxel drive.
 14. parallel/: the SE2 graph solve in three layouts (whole chain, the
     SPIKE core solve with 16 segments, and optimize_se2's automatic route,
     the locality-aware SPIKE solve) on phase 6's 4096-node graph (cold
     start, 30 iterations) and on bench_multichip.py:123's 16384-node
     two-lap graph (warm start, 8 iterations): each twice (bitwise equal
     within a layout), one step of each against a float64 host solve
     (SuperLU) to 1e-9 relative with nothing dropped, final chi2 across
     layouts to DIVERGENCES.md section 13's contract (1e-3 relative cold,
     1e-2 warm, as bench_multichip.py holds it), ms and CUDA kernels per
     LM iteration; then MultiBagOdometry over phase 4's frames at full
     capacity, B = 1 and B = 8 bags (bag b replays the frames from frame b,
     bench_multichip.py:205), FAST_GICP with voxel correspondences (32
     lockstep frames), then brute ones through the batched nn1 launch (8
     frames: a brute model's kNN covariances search the whole cloud in
     plain PyTorch): every bag of the B = 8 run
     held to its own B = 1 drive (1e-3 m, 1e-4 rotation) and, with voxel
     correspondences, every bag at every step to the reference's
     (``multibag_voxel``) as in phase 4, aggregate
     scans/s and CUDA kernels per GN iteration at both B; the batched nn1
     kernel at the brute drive's shape against its plain version and
     against B single launches (bitwise), timed both ways and beside B
     back-to-back torch.cdist(q, t).min(1) calls.
Phase 5 also runs a deskewed variant (deskewing on, a constant angular
velocity fed through on_imu), card against CPU.
The line before the last is the kernel report, the last line the result.
With --out, a JSON file with every measurement goes into DIR.
"""

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_FRAMES = 40
REPLACES = "delta_graph_slam_tpu/ops/pallas_nn.py:30"
FP32_FLOPS = 67e12        # H100 SXM, FP32 outside the tensor cores, 700 W
HBM_BYTES_S = 3.35e12     # H100 SXM HBM3
FLOP_PER_PAIR = 8         # |q - t|^2: 3 subtracts, 3 multiplies, 2 adds
EMPTY_OSM = "<osm></osm>"
GRAPH_NODES = 4096
LAP_FRAMES = 120
CITY_WARMUP = 10
CITY_FRAMES = 240
SE3_LM_ITERS = 128        # bench.py:1028
SE3_CAPTURE_ITERS = 5     # eager against replayed LM iterations (phase 9)
IMU_FRAMES = 60
DESKEW_RATE = [0.0, 0.0, 0.5]   # rad/s about z: a car in a gentle turn
SPIKE_WARM_NODES = 16384        # bench_multichip.py:123
SPIKE_WARM_ITERS = 8            # bench_multichip.py:123 (lm_iters)
MB_BAGS = 8                     # bench_multichip.py:224
MB_STEPS = 32                   # lockstep frames a bag (phase 4 has 40)
MB_BRUTE_STEPS = 8              # brute: every model's kNN covariances search
                                # the whole cloud in plain PyTorch


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def cuda_ms(fn, reps=20, warmup=3, inner=1):
    """Median milliseconds of ``fn`` on the card over ``reps`` timings of
    ``inner`` back-to-back calls each (inner > 1 keeps the host's launch
    latency out of a short kernel's time)."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(inner):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / inner)
    return statistics.median(times)


def smi(query):
    """One nvidia-smi reading of ``query`` (comma-separated fields)."""
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def sampled_clocks(fn):
    """Runs ``fn`` while nvidia-smi samples the SM clock every 50 ms;
    returns (fn's result, the samples in MHz)."""
    proc = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm",
                             "--format=csv,noheader,nounits", "-lms", "50"],
                            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                            text=True)
    try:
        out = fn()
    finally:
        proc.terminate()
        text, _ = proc.communicate(timeout=60)
    mhz = [int(x) for x in text.split() if x.isdigit()]
    return out, mhz


def nn_cases(rng):
    """(name, query, qmask, target, tmask, exclude_self) on the host."""
    def box(n):
        # a street-sized box: |p|^2 stays below ~1.3e3 m^2, where float32
        # rounding of |q|^2 - 2q.t + |t|^2 stays well under the 1e-3 limit
        return np.stack([rng.uniform(-25, 25, n), rng.uniform(-25, 25, n),
                         rng.uniform(-2, 3, n)], 1).astype(np.float32)

    from delta_graph_slam_tpu_torch.ops.nn_kernel import tie_case

    big = 32768
    prefix = np.arange(big) < 28000               # compacted clouds: a prefix
    q1, t1 = box(1000), box(3001)
    self_pts = box(8192)
    self_mask = rng.random(8192) > 0.1
    return [
        ("fitness_32768x32768", box(big), prefix.copy(), box(big),
         np.arange(big) < 27500, False),
        ("ragged_1000x3001", q1, rng.random(1000) > 0.1, t1,
         rng.random(3001) > 0.2, False),
        ("single_query_1x4097", box(1), np.ones(1, bool), box(4097),
         rng.random(4097) > 0.2, False),
        ("exclude_self_8192", self_pts, self_mask, self_pts, self_mask, True),
        ("all_targets_invalid", q1, rng.random(1000) > 0.1, t1,
         np.zeros(3001, bool), False),
        ("ties_3000x8192", *tie_case(rng), False),
    ]


def kernel_vs_plain(report):
    import torch

    from delta_graph_slam_tpu_torch.ops import knn, nn_kernel

    rng = np.random.default_rng(0)
    worst = 0.0
    for name, q, qm, t, tm, excl in nn_cases(rng):
        args = [torch.from_numpy(x).cuda() for x in (q, qm, t, tm)]
        d2_k, i_k = nn_kernel.nn_1_cuda(*args, exclude_self=excl)
        d2_r, i_r = knn.nn_1_reference(*args, exclude_self=excl)
        torch.cuda.synchronize()
        d2_k, i_k, d2_r, i_r = (x.cpu().numpy() for x in (d2_k, i_k, d2_r, i_r))
        check(np.array_equal(np.isinf(d2_k), np.isinf(d2_r)),
              f"{name}: inf pattern differs from the plain version")
        fin = np.isfinite(d2_r)
        err = float(np.abs(d2_k[fin] - d2_r[fin]).max()) if fin.any() else 0.0
        agree = float((i_k[fin] == i_r[fin]).mean()) if fin.any() else 1.0
        worst = max(worst, err)
        print(f"{name}: max |d2 err| {err:.3g} (limit 1e-3), index agreement "
              f"{agree:.5f} (limit 0.99), finite {int(fin.sum())}", flush=True)
        check(err <= 1e-3, f"{name}: d2 error {err} > 1e-3")
        check(agree >= 0.99, f"{name}: index agreement {agree} < 0.99")
        if name.startswith("ties"):
            check(np.array_equal(i_k, i_r) and (i_k < len(t) // 4).all(),
                  f"{name}: indices differ from the plain version's first copy")
        report["kernel_cases"][name] = {"max_abs_err": err, "index_agreement": agree}

    # the fitness shape, the one every odometry edge runs
    _, q, qm, t, tm, _ = nn_cases(np.random.default_rng(0))[0]
    args = [torch.from_numpy(x).cuda() for x in (q, qm, t, tm)]
    runs = [nn_kernel.nn_1_cuda(*args) for _ in range(3)]
    same = all(torch.equal(a, b) for r in runs[1:] for a, b in zip(r, runs[0]))
    print(f"fitness case three times: bitwise equal {same}", flush=True)
    check(same, "the kernel's outputs differ between runs on the same inputs")

    nq, nt = int(qm.sum()), int(tm.sum())
    qv, tv = args[0][:nq], args[2][:nt]          # the valid prefixes
    (ms, plain_ms, library_ms), mhz = sampled_clocks(lambda: (
        cuda_ms(lambda: nn_kernel.nn_1_cuda(*args), inner=10),
        cuda_ms(lambda: knn.nn_1_reference(*args)),
        cuda_ms(lambda: torch.cdist(qv, tv).min(dim=1))))
    pairs = nq * nt
    flop_ms = FLOP_PER_PAIR * pairs / FP32_FLOPS * 1e3
    io_bytes = sum(x.numel() * x.element_size() for x in args) + len(q) * 8
    byte_ms = io_bytes / HBM_BYTES_S * 1e3
    bound_ms = max(flop_ms, byte_ms)
    timing = {
        "ms": ms, "plain_ms": plain_ms, "library_ms": library_ms,
        "bound_ms": bound_ms, "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
        "bound_share": bound_ms / ms, "valid_pairs": pairs, "flop_ms": flop_ms,
        "byte_ms": byte_ms, "sm_clock_mhz": mhz,
        "power_limit": smi("power.limit"),
    }
    print(f"nn1 at 32768x32768 ({nq} x {nt} valid): kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, torch.cdist().min(1) {library_ms:.4f} ms (medians "
          f"of 20, CUDA events); bound {bound_ms:.4f} ms ({FLOP_PER_PAIR} FLOP x "
          f"{pairs} pairs at 67 TFLOP/s FP32), {100 * bound_ms / ms:.1f}% of it; "
          f"SM clock {min(mhz, default=0)}-{max(mhz, default=0)} MHz over "
          f"{len(mhz)} samples, power limit {timing['power_limit']}", flush=True)
    report["nn1_timing"] = timing
    return worst, timing


def rel_gt(frames):
    from delta_graph_slam_tpu_torch.geom.host import se2_compose_np, se2_inverse_np

    g0 = se2_inverse_np(frames[0].gt_pose)
    return [se2_compose_np(g0, fr.gt_pose) for fr in frames]


def odometry_edges(backend):
    return [e for e in backend.graph.edges if e["id"] != backend.anchor_edge_id]


def make_pipeline(cfg, device="cuda"):
    """The delta pipeline on ``device`` in a world without OSM buildings."""
    from delta_graph_slam_tpu_torch.buildings import StaticProvider
    from delta_graph_slam_tpu_torch.pipeline.runner import Pipeline

    return Pipeline(cfg, building_provider=StaticProvider(EMPTY_OSM),
                    device=device)


def drive(pipe, frames, gts=None, angular_velocity=None):
    """GPS (and an IMU sample with ``angular_velocity``) then the scan of
    every frame; returns the odometry frames."""
    out = []
    for k, fr in enumerate(frames):
        pipe.on_gps(fr.stamp, *fr.gps)
        if angular_velocity is not None:
            pipe.on_imu(fr.stamp, [1.0, 0.0, 0.0, 0.0],
                        angular_velocity=angular_velocity)
        out.append(pipe.on_points(fr.stamp, fr.points,
                                  gt_pose=None if gts is None else gts[k]))
    return out


def run_slice(report, reference):
    import torch

    from delta_graph_slam_tpu_torch.config import get_preset
    from delta_graph_slam_tpu_torch.io.lidar_sim import raycast_city_sequence
    from delta_graph_slam_tpu_torch.ops import nn_kernel

    t0 = time.perf_counter()
    _, frames = raycast_city_sequence(n_frames=N_FRAMES, speed=3.0)
    print(f"generated {N_FRAMES} raycast frames in "
          f"{time.perf_counter() - t0:.1f} s (host numpy; "
          f"{np.mean([len(f.points) for f in frames]):.0f} returns/frame)",
          flush=True)
    cfg = get_preset("delta")
    # a first run of the same frames: the warm-up (CUDA context, cuBLAS,
    # allocator) and the twin of the repeatability check below
    first = make_pipeline(cfg)
    odo_first = drive(first, frames)
    first.finish()
    torch.cuda.synchronize()

    pipe = make_pipeline(cfg)
    torch.cuda.reset_peak_memory_stats()
    nn_kernel.launches = 0
    t0 = time.perf_counter()
    odo = drive(pipe, frames)
    pipe.finish()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = nn_kernel.launches
    same = all(np.array_equal(a.pose, b.pose) for a, b in zip(odo, odo_first))
    print(f"two runs of the {N_FRAMES} frames: odometry poses bitwise equal "
          f"{same}", flush=True)
    check(same, "the front end's odometry differs between two runs of the "
          "same frames")

    edges = odometry_edges(pipe.backend)
    finite = [e for e in edges if np.isfinite(e["info"]).all()]
    converged = np.mean([f.converged for f in odo[1:]])
    gt = rel_gt(frames)
    path = float(sum(np.linalg.norm(gt[k + 1][:2] - gt[k][:2])
                     for k in range(len(gt) - 1)))
    drift = float(np.linalg.norm(odo[-1].pose[:2, 3] - gt[-1][:2]))
    iters = [f.iterations for f in odo[1:]]
    timing = pipe.timing_summary()
    per_frame = {k: v["total_s"] * 1000.0 / N_FRAMES for k, v in timing.items()}
    print(f"odometry edges {len(edges)} (finite information {len(finite)}), "
          f"keyframes {len(pipe.backend.keyframes)}, nn1 launches {launches}",
          flush=True)
    print(f"converged {converged:.3f} of frames, drift {drift:.4f} m over "
          f"{path:.3f} m ({100 * drift / path:.3f}%), GN iterations/frame "
          f"mean {np.mean(iters):.2f} max {max(iters)}", flush=True)
    print(f"{N_FRAMES} frames in {wall:.3f} s: {N_FRAMES / wall:.3f} frames/s; "
          "ms/frame " + ", ".join(f"{k} {v:.3f}" for k, v in per_frame.items()),
          flush=True)
    report["slice"] = {
        "frames": N_FRAMES, "wall_s": wall, "frames_per_s": N_FRAMES / wall,
        "ms_per_frame": per_frame, "timing": timing,
        "odometry_edges": len(edges), "finite_edges": len(finite),
        "nn1_launches": launches, "converged_fraction": float(converged),
        "repeatable": same,
        "drift_m": drift, "path_m": path, "gn_iterations": iters,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }
    check(len(finite) >= 4, f"{len(finite)} odometry edges with finite "
          "information, need 4")
    check(launches >= len(edges),
          f"nn1 launched {launches} times for {len(edges)} edges")
    check(converged >= 0.9, f"only {converged:.3f} of frames converged")
    check(drift <= 0.05 * path, f"drift {drift:.3f} m > 5% of {path:.3f} m")
    misses = held_to_reference("front", front_arrays(odo), reference, report)
    check(not misses, f"the front end against the reference: {misses}")
    return launches, frames


def voxel_sums(report):
    """The per-cell sums of ops/voxel.py at the front end's two shapes, on
    one full-capacity raycast scan: the run-wise ``segment_sum`` the port
    uses against the float ``index_add_`` (CUDA atomics) it replaced,
    CUDA-event medians, and how many outputs change over five runs of
    each. The two must agree to float32 rounding; the run-wise sum must
    not change."""
    import torch

    from delta_graph_slam_tpu_torch.config import get_preset
    from delta_graph_slam_tpu_torch.io.kitti import make_city_world
    from delta_graph_slam_tpu_torch.io.lidar_sim import raycast_scan
    from delta_graph_slam_tpu_torch.ops import voxel
    from delta_graph_slam_tpu_torch.ops.cloud import make_cloud
    from delta_graph_slam_tpu_torch.ops.segment import segment_sum

    pre = get_preset("delta").prefiltering
    scan = raycast_scan(make_city_world(seed=0), np.array([-40.0, 0.5, 0.0]), seed=0)
    cloud = make_cloud(scan[:, :3], capacity=pre.raw_capacity, device="cuda")
    report["voxel_sums"] = []
    # (resolution, cells, columns): voxel_downsample's centroid sums and
    # build_voxel_hash's cell statistics at the registration's 1 m
    for res, cells, cols in ((pre.downsample_resolution, pre.out_capacity, 4),
                             (1.0, 8192, 13)):
        pts_s, _, valid_s, first = voxel._sorted_segments(cloud.points, cloud.mask, res)
        seg = voxel._segment_ids(first, valid_s, cells)
        vals = torch.cat([pts_s] * 5, 1)[:, :cols].contiguous()
        sums = {
            "segment_sum": lambda: segment_sum(vals, seg, cells, sorted_ids=True),
            "index_add_": lambda: vals.new_zeros((cells + 1, cols))
            .index_add_(0, seg, vals)[:-1],
        }
        row = {"resolution": res, "rows": len(seg), "valid_rows": int(valid_s.sum()),
               "cells": cells, "columns": cols}
        first_out = {}
        for name, fn in sums.items():
            outs = [fn() for _ in range(5)]
            first_out[name] = outs[0]
            row[name] = {"ms": cuda_ms(fn),
                         "changing_over_5_runs": int(sum((o != outs[0]).sum() for o in outs))}
        ref = first_out["index_add_"]
        gap = float((first_out["segment_sum"] - ref).abs().max())
        row["max_abs_gap"] = gap
        print(f"voxel sums at {res} m, {cells} cells x {cols} columns "
              f"({row['valid_rows']} of {row['rows']} rows valid): segment_sum "
              f"{row['segment_sum']['ms']:.4f} ms, "
              f"{row['segment_sum']['changing_over_5_runs']} outputs changing over "
              f"5 runs; index_add_ {row['index_add_']['ms']:.4f} ms, "
              f"{row['index_add_']['changing_over_5_runs']} changing; max gap {gap:.3g}",
              flush=True)
        report["voxel_sums"].append(row)
        check(row["segment_sum"]["changing_over_5_runs"] == 0,
              "the run-wise voxel sum changed between runs")
        # float32 sums of the same values in another order: within 1e-4 of
        # the largest cell sum
        check(gap <= 1e-4 * float(ref.abs().max()),
              f"segment_sum and index_add_ differ by {gap}")


def small_check(report):
    """The slice at a small size on the card (kernel) and on the CPU
    (plain versions): the same odometry and edges within the parity
    tolerances of tests/test_torch_pipeline.py."""
    from delta_graph_slam_tpu_torch.config import get_preset
    from delta_graph_slam_tpu_torch.io.lidar_sim import raycast_city_sequence

    cfg = get_preset("delta")
    cfg = dataclasses.replace(
        cfg,
        prefiltering=dataclasses.replace(cfg.prefiltering, raw_capacity=16384,
                                         out_capacity=4096, chunk=1024),
        delta=dataclasses.replace(cfg.delta, keyframe_delta_trans=1.0,
                                  keyframe_delta_angle=1.0),
    )
    _, frames = raycast_city_sequence(n_frames=10, speed=3.0, seed=5)
    deskewed = dataclasses.replace(cfg, prefiltering=dataclasses.replace(
        cfg.prefiltering, deskewing=True))
    report["small_check"] = {}
    for name, c, spin in (("plain", cfg, None), ("deskewed", deskewed, DESKEW_RATE)):
        runs = []
        for device in ("cuda", "cpu"):
            pipe = make_pipeline(c, device)
            odo = drive(pipe, frames, angular_velocity=spin)
            pipe.finish()
            runs.append((odo, odometry_edges(pipe.backend)))
        (odo_g, edges_g), (odo_c, edges_c) = runs
        eps = cfg.odometry.registration.transformation_epsilon
        worst = 0.0
        for k, (g, cc) in enumerate(zip(odo_g, odo_c)):
            dt = float(np.abs(g.pose[:3, 3] - cc.pose[:3, 3]).max())
            worst = max(worst, dt)
            lim = 1e-2 if g.iterations == cc.iterations else eps
            check(dt < lim, f"small check ({name}) frame {k}: card and CPU poses "
                  f"{dt} m apart")
        check(len(edges_g) == len(edges_c) >= 2,
              f"small check ({name}): {len(edges_g)} vs {len(edges_c)} odometry edges")
        for eg, ec in zip(edges_g, edges_c):
            check(np.allclose(eg["info"], ec["info"], rtol=1e-3),
                  f"small check ({name}): information matrices differ beyond rtol 1e-3")
        print(f"small check ({name}): card vs CPU poses within {worst:.2e} m, "
              f"{len(edges_g)} odometry edges agree", flush=True)
        report["small_check"][name] = {"max_pose_gap_m": worst, "edges": len(edges_g)}


# ------------------------------------------------------------ graph solve

def _wrap(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def bench_graph(n_nodes, rng_seed=7, n_laps=2):
    """The pose graph of bench.py:340-393 in numpy: ``n_laps`` laps of a
    circle, noisy odometry (sigma 0.01 m, 0.01 m, 0.002 rad), vertices
    initialized by integrating it, Huber loop closures every 100 nodes
    between laps, info diag(100, 100, 400).

    Returns (init (n,3), edges [(i, j, meas, kernel)], gt (n,3))."""
    def compose(a, m):
        c, s = np.cos(a[2]), np.sin(a[2])
        return np.array([a[0] + c * m[0] - s * m[1],
                         a[1] + s * m[0] + c * m[1], _wrap(a[2] + m[2])])

    def rel(a, b):
        c, s = np.cos(a[2]), np.sin(a[2])
        dx, dy = b[0] - a[0], b[1] - a[1]
        return np.array([c * dx + s * dy, -s * dx + c * dy, _wrap(b[2] - a[2])])

    rng = np.random.default_rng(rng_seed)
    lap = n_nodes // n_laps
    gt = np.zeros((n_nodes, 3))
    for k in range(1, n_nodes):
        gt[k] = compose(gt[k - 1], [1.0, 0.0, 2.0 * np.pi / lap])
    meas = [rel(gt[k], gt[k + 1]) + rng.normal(0, [0.01, 0.01, 0.002])
            for k in range(n_nodes - 1)]
    init = np.zeros((n_nodes, 3))
    for k in range(1, n_nodes):
        init[k] = compose(init[k - 1], meas[k - 1])
    edges = [(k, k + 1, meas[k], "NONE") for k in range(n_nodes - 1)]
    for left in range(0, n_nodes - lap, lap):
        for k in range(left, left + lap - 1, 100):
            m = rel(gt[k], gt[k + lap]) + rng.normal(0, 0.005, 3)
            edges.append((k, k + lap, m, "Huber"))
    return init, edges, gt


GRAPH_INFO = np.diag([100.0, 100.0, 400.0])


def graph_builder(init, edges, device, dtype=np.float32):
    """The port's SE2GraphBuilder of a bench_graph (vertex 0 fixed)."""
    from delta_graph_slam_tpu_torch.graph import SE2GraphBuilder

    b = SE2GraphBuilder(dtype=dtype, device=device)
    for k, p in enumerate(init):
        b.add_vertex(p, fixed=(k == 0))
    for i, j, m, kern in edges:
        b.add_se2_edge(i, j, m, GRAPH_INFO, kernel=kern, delta=1.0)
    return b


def _host_linearize(x, ei, ej, meas):
    """Residual + analytic SE2 Jacobians in float64 numpy (bench.py:618)."""
    E = len(ei)
    xi, xj = x[ei], x[ej]
    ci, si = np.cos(xi[:, 2]), np.sin(xi[:, 2])
    cm, sm = np.cos(meas[:, 2]), np.sin(meas[:, 2])
    dx, dy = xj[:, 0] - xi[:, 0], xj[:, 1] - xi[:, 1]
    lx, ly = ci * dx + si * dy, -si * dx + ci * dy
    r = np.stack([cm * (lx - meas[:, 0]) + sm * (ly - meas[:, 1]),
                  -sm * (lx - meas[:, 0]) + cm * (ly - meas[:, 1]),
                  _wrap(xj[:, 2] - xi[:, 2] - meas[:, 2])], 1)
    A = np.empty((E, 2, 2))
    A[:, 0, 0] = cm * ci - sm * si
    A[:, 0, 1] = cm * si + sm * ci
    A[:, 1, 0] = -sm * ci - cm * si
    A[:, 1, 1] = -sm * si + cm * ci
    dlx, dly = -si * dx + ci * dy, -ci * dx - si * dy
    Ji = np.zeros((E, 3, 3))
    Ji[:, :2, :2] = -A
    Ji[:, 0, 2] = cm * dlx + sm * dly
    Ji[:, 1, 2] = -sm * dlx + cm * dly
    Ji[:, 2, 2] = -1.0
    Jj = np.zeros((E, 3, 3))
    Jj[:, :2, :2] = A
    Jj[:, 2, 2] = 1.0
    return r, Ji, Jj


def _host_robust(r, infos, huber, delta):
    """g2o Huber: chi2 = sum rho(e2) and the IRLS weights rho'(e2)."""
    e2 = np.einsum("ea,eab,eb->e", r, infos, r)
    d2 = delta * delta
    out = huber & (e2 > d2)
    sq = np.sqrt(np.maximum(e2, 1e-30))
    return (np.where(out, 2.0 * delta * sq - d2, e2).sum(),
            np.where(out, delta / sq, 1.0))


def host_lm(builder, max_iters):
    """Float64 robust LM on the host, the oracle of bench.py:655
    (bench_pose_graph_cpu): the builder's se2 edges, Huber on flagged ones,
    g2o's gain-ratio lambda schedule from 1e-5 * 400, scipy SuperLU, vertex
    0 clamped. Returns (seconds, iterations, chi2, poses (V,3))."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl

    es = [e for e in builder.edges if e["type"] == "se2"]
    ei = np.asarray([e["i"] for e in es])
    ej = np.asarray([e["j"] for e in es])
    meas = np.asarray([e["meas"] for e in es], np.float64)
    infos = np.asarray([e["info"] for e in es], np.float64)
    huber = np.asarray([e["kernel"] == 1 for e in es])
    delta = np.asarray([e["delta"] for e in es], np.float64)
    x = np.asarray(builder.poses, np.float64).copy()
    V = len(x)
    a3 = np.arange(3)

    def blk(v, w):
        r = np.broadcast_to(3 * v[:, None, None] + a3[None, :, None], (len(v), 3, 3))
        c = np.broadcast_to(3 * w[:, None, None] + a3[None, None, :], (len(v), 3, 3))
        return r.ravel(), c.ravel()

    (r_ii, c_ii), (r_ij, c_ij) = blk(ei, ei), blk(ei, ej)
    (r_ji, c_ji), (r_jj, c_jj) = blk(ej, ei), blk(ej, ej)
    rows = np.concatenate([r_ii, r_ij, r_ji, r_jj, a3])
    cols = np.concatenate([c_ii, c_ij, c_ji, c_jj, a3])

    t0 = time.perf_counter()
    r, Ji, Jj = _host_linearize(x, ei, ej, meas)
    chi2, w = _host_robust(r, infos, huber, delta)
    lam, nu, it = 1e-5 * 400.0, 2.0, 0
    while it < max_iters:
        Wf = infos * w[:, None, None]
        JiT_W = np.einsum("eba,ebc->eac", Ji, Wf)
        JjT_W = np.einsum("eba,ebc->eac", Jj, Wf)
        Hij = JiT_W @ Jj
        Hb = np.zeros(3 * V)
        np.add.at(Hb, (3 * ei[:, None] + a3).ravel(),
                  np.einsum("eab,eb->ea", JiT_W, r).ravel())
        np.add.at(Hb, (3 * ej[:, None] + a3).ravel(),
                  np.einsum("eab,eb->ea", JjT_W, r).ravel())
        vals = np.concatenate([(JiT_W @ Ji).ravel(), Hij.ravel(),
                               Hij.transpose(0, 2, 1).ravel(),
                               (JjT_W @ Jj).ravel(), np.full(3, 1e12)])
        H = sp.coo_matrix((vals, (rows, cols)), shape=(3 * V, 3 * V)).tocsc()
        dx = spl.splu(H + sp.identity(3 * V, format="csc") * lam).solve(-Hb)
        xt = x + dx.reshape(V, 3)
        xt[:, 2] = _wrap(xt[:, 2])
        rt, Ji_t, Jj_t = _host_linearize(xt, ei, ej, meas)
        chi2_t, w_t = _host_robust(rt, infos, huber, delta)
        rho = (chi2 - chi2_t) / max(abs(np.sum(dx * (lam * dx - Hb))), 1e-30)
        if chi2_t < chi2:
            x, chi2, r, Ji, Jj, w = xt, chi2_t, rt, Ji_t, Jj_t, w_t
            lam *= max(1.0 / 3.0, 1.0 - (2 * rho - 1) ** 3)
            nu = 2.0
        else:
            lam *= nu
            nu *= 2.0
        it += 1
        if lam > 1e12:
            break
    return time.perf_counter() - t0, it, float(chi2), x


def graph_solve(report):
    """The 4096-node bench graph on the card against the host oracle."""
    import torch

    from delta_graph_slam_tpu_torch.graph import SolverConfig, optimize_se2

    init, edges, gt = bench_graph(GRAPH_NODES)
    b = graph_builder(init, edges, "cuda")
    g = b.to_arrays(chain_first=True)
    nc, hint = g.poses.shape[0] - 1, b.count_offchain(0)
    cfg = SolverConfig(backend="chain", max_iterations=30)

    def solve(c):
        out = optimize_se2(g, level=0, config=c, off_hint=hint, n_chain=nc)
        torch.cuda.synchronize()
        return out

    t0 = time.perf_counter()
    solve(cfg)
    first_s = time.perf_counter() - t0
    runs = [solve(cfg) for _ in range(2)]
    (p1, s1), (p2, s2) = runs
    chi2 = [float(s.chi2_final) for s in (s1, s2)]
    same_poses = bool(torch.equal(p1, p2))
    ate = float(np.mean(np.linalg.norm(p1.cpu().numpy()[:, :2] - gt[:, :2], axis=1)))
    print(f"card: chi2 {chi2[0]!r} / {chi2[1]!r} after {s1.iterations} / "
          f"{s2.iterations} iterations (bit-identical chi2 "
          f"{chi2[0] == chi2[1]}, poses {same_poses}), ATE {ate:.4f} m, "
          f"dropped off-chain {int(s1.n_offchain_dropped)}, first solve "
          f"{first_s:.2f} s", flush=True)
    check(chi2[0] == chi2[1] and s1.iterations == s2.iterations,
          "two solves of the same graph differ: "
          f"chi2 {chi2} iterations {s1.iterations}/{s2.iterations}")
    check(int(s1.n_offchain_dropped) == 0, "the solve dropped off-chain edges")

    # ms/iteration, the marginal protocol of bench.py:431-457: the cost
    # between two iteration caps with the early exits off, best of 3
    times = {}
    for cap in (10, 30):
        cfg_c = dataclasses.replace(cfg, max_iterations=cap, chi2_rel_tol=0.0,
                                    dx_tol=0.0)
        solve(cfg_c)
        best, its = float("inf"), 0
        for _ in range(3):
            t0 = time.perf_counter()
            _, st = solve(cfg_c)
            best = min(best, time.perf_counter() - t0)
            its = st.iterations
        times[cap] = (best, its)
    (t1, i1), (t2, i2) = times[10], times[30]
    ms_iter = (t2 - t1) * 1000.0 / max(i2 - i1, 1)

    b_host = graph_builder(init, edges, "cpu")
    th, ih, chi2_h, xh = host_lm(b_host, 60)
    th20, ih20, _, _ = host_lm(b_host, 20)
    host_ms = (th - th20) * 1000.0 / max(ih - ih20, 1)
    ate_h = float(np.mean(np.linalg.norm(xh[:, :2] - gt[:, :2], axis=1)))
    print(f"host float64 LM (scipy SuperLU): chi2 {chi2_h!r} after {ih} "
          f"iterations, ATE {ate_h:.4f} m", flush=True)
    print(f"LM ms/iteration at {GRAPH_NODES} nodes: card {ms_iter:.3f} "
          f"(marginal {i1}->{i2} iterations), host oracle {host_ms:.3f}",
          flush=True)
    report["graph"] = {
        "nodes": GRAPH_NODES, "offchain": hint, "chi2": chi2[0],
        "iterations": s1.iterations, "ate_m": ate, "poses_bit_identical": same_poses,
        "first_solve_s": first_s, "ms_per_iter": ms_iter, "marginal": times,
        "host_chi2": chi2_h, "host_iterations": ih, "host_ate_m": ate_h,
        "host_ms_per_iter": host_ms, "host_s": th,
    }
    check(np.isfinite(chi2[0]) and chi2[0] <= 1.02 * chi2_h,
          f"card chi2 {chi2[0]} above 1.02 x the host optimum {chi2_h}")


# ------------------------------------------------------------ backend drive

def backend_drive(frames, gts, loops_on=True):
    """One lap through the delta preset without buildings; returns
    (pipeline, non-empty per-cycle stats, nn1 launches of the loop
    validation, wall seconds)."""
    import torch

    from delta_graph_slam_tpu_torch.config import get_preset
    from delta_graph_slam_tpu_torch.ops import nn_kernel

    cfg = get_preset("delta")
    over = dict(enable_buildings=False)
    if not loops_on:
        over["distance_thresh"] = 0.0          # odometry only (bench.py:209)
    cfg = dataclasses.replace(cfg, delta=dataclasses.replace(cfg.delta, **over))
    pipe = make_pipeline(cfg)
    trace_drive(pipe)
    cycles, loop_launches = [], [0]
    step, matching = pipe.backend.optimization_step, pipe.backend.loop_detector.matching

    def counted_step():
        out = step()
        cycles.append(out)
        return out

    def counted_matching(*a):
        n0 = nn_kernel.launches
        out = matching(*a)
        loop_launches[0] += nn_kernel.launches - n0
        return out

    pipe.backend.optimization_step = counted_step
    pipe.backend.loop_detector.matching = counted_matching
    t0 = time.perf_counter()
    drive(pipe, frames, gts)
    pipe.finish()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return pipe, [c for c in cycles if c], loop_launches[0], wall


def run_backend(report, frames, reference):
    from delta_graph_slam_tpu_torch.ops import nn_kernel

    gts = rel_gt(frames)
    nn_kernel.launches = 0
    pipe, cycles, loop_launches, wall = backend_drive(frames, gts)
    launches = nn_kernel.launches
    be = pipe.backend
    m = pipe.evaluate()
    loops = len(loop_edge_pairs(be))
    t = pipe.timing_summary()

    def ms(k):
        return t[k]["mean_ms"] if k in t else float("nan")

    chi2s = [c["chi2_level0"] for c in cycles]
    print(f"{len(frames)} frames in {wall:.3f} s: {len(frames) / wall:.3f} "
          f"frames/s; keyframes {len(be.keyframes)}, loop edges {loops}, "
          f"cycles {len(cycles)}, nn1 launches {launches} ({loop_launches} "
          "in loop validation)", flush=True)
    print("ms per call: optimization_step {:.3f}, loop_detection {:.3f}, "
          "optimize_level0 {:.3f}, optimize_level1 {:.3f}".format(
              ms("optimization_step"), ms("backend.loop_detection"),
              ms("backend.optimize_level0"), ms("backend.optimize_level1")),
          flush=True)
    print(f"chi2_level0 per cycle {chi2s}", flush=True)
    print("ATE {ATE_mean:.4f} m (std {ATE_std:.4f}), t-RPE {t_RPE_mean:.4f} m, "
          "r-RPE {r_RPE_mean:.5f} rad".format(**m), flush=True)

    pipe_o, _, _, _ = backend_drive(frames, gts, loops_on=False)
    m_odo = pipe_o.evaluate()
    print(f"odometry only (distance_thresh 0): ATE {m_odo['ATE_mean']:.4f} m, "
          f"loop edges {len(loop_edge_pairs(pipe_o.backend))}", flush=True)
    misses = (held_to_reference("lap", pipe, reference, report)
              + held_to_reference("lap_no_loops", pipe_o, reference, report))
    report["backend"] = {
        "frames": len(frames), "wall_s": wall, "frames_per_s": len(frames) / wall,
        "keyframes": len(be.keyframes), "loop_edges": loops, "cycles": cycles,
        "nn1_launches": launches, "nn1_loop_launches": loop_launches,
        "metrics": m, "odometry_only_metrics": m_odo, "timing": t,
    }
    check(loops >= 1, "no loop edge on the lap")
    check(loop_launches >= 1, "loop validation launched no nn1 kernel")
    check(cycles and all(np.isfinite(c) for c in chi2s),
          f"chi2_level0 not finite on every cycle: {chi2s}")
    check(m["ATE_mean"] <= 1.0, f"ATE {m['ATE_mean']} m > 1.0 m")
    check(not misses, f"the laps against the reference: {misses}")
    return launches


# ---------------------------------------------------------- buildings drive

def recorded(pipe):
    """Counts the backend's update steps (their non-empty stats) and records
    the odometry pose of every frame as bytes, whichever thread runs them."""
    cycles, odo = [], []
    step, matching = pipe.backend.optimization_step, pipe.odometry.matching

    def counted_step():
        out = step()
        cycles.append(out)
        return out

    def recorded_matching(*a, **kw):
        frame = matching(*a, **kw)
        odo.append(np.asarray(frame.pose).tobytes())
        return frame

    pipe.backend.optimization_step = counted_step
    pipe.odometry.matching = recorded_matching
    return cycles, odo


def settle(pipe, n_frames, timeout=600.0):
    """Threaded: wait until the backend worker has taken ``n_frames``."""
    t0 = time.perf_counter()
    while pipe.threaded and pipe.frames_processed < n_frames:
        check(pipe._worker_error is None, f"worker error: {pipe._worker_error!r}")
        check(time.perf_counter() - t0 < timeout,
              f"{pipe.frames_processed} of {n_frames} frames after {timeout} s")
        time.sleep(0.005)


def timed_drive(pipe, frames, gts, warmup, feed, window=None):
    """bench.py's protocol: ``warmup`` frames and two update steps, the
    timers reset, then the timed frames and finish(). Returns (wall seconds
    to the last on_points return, to the end of finish()). ``window(pipe)``,
    a context manager, encloses the timed frames and finish()."""
    import torch

    for fr, gt in zip(frames[:warmup], gts):
        feed(fr, gt)
    settle(pipe, warmup)
    pipe.optimize()
    pipe.optimize()
    pipe.timer.reset()
    pipe.backend.timer.reset()
    torch.cuda.synchronize()
    with window(pipe) if window is not None else contextlib.nullcontext():
        t0 = time.perf_counter()
        for fr, gt in zip(frames[warmup:], gts[warmup:]):
            feed(fr, gt)
        if not pipe.threaded:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        pipe.finish()
        torch.cuda.synchronize()
        wall_finish = time.perf_counter() - t0
    return wall, wall_finish


def city_drive(world, frames, gts, buildings=True, threaded=False, trace=True,
               window=None, preset="delta", warmup=CITY_WARMUP, gps=True, watch=None):
    """bench.py:127-187 without its compile pass: the delta preset at full
    capacity, ``warmup`` frames and two update steps, the timers reset,
    then the timed frames (GPS before every scan unless ``gps`` is off) and
    finish(). Returns (pipeline, non-empty per-cycle stats, wall seconds of
    the timed frames to the last on_points return and to finish(), the
    odometry of every frame). ``trace=False`` leaves out the hooks that
    record the steps and the odometry and read the graph (the stats and the
    odometry then come back empty); ``window`` goes to timed_drive;
    ``watch(pipe)`` may wrap the pipeline's parts before the drive."""
    from delta_graph_slam_tpu_torch.buildings import StaticProvider
    from delta_graph_slam_tpu_torch.config import get_preset
    from delta_graph_slam_tpu_torch.pipeline.runner import Pipeline

    cfg = get_preset(preset)
    if not buildings:     # the no_buildings variant of bench.py:190-218
        cfg = dataclasses.replace(cfg, delta=dataclasses.replace(
            cfg.delta, enable_buildings=False))
    pipe = Pipeline(cfg, building_provider=StaticProvider(
        world.osm_xml() if buildings else EMPTY_OSM), device="cuda", threaded=threaded)
    cycles, odo = recorded(pipe) if trace else ([], [])
    if trace and not threaded:     # the trace reads the graph between update steps
        trace_drive(pipe)
    if watch is not None:
        watch(pipe)

    def feed(fr, gt):
        if gps:
            pipe.on_gps(fr.stamp, *fr.gps)
        pipe.on_points(fr.stamp, fr.points, gt_pose=gt)

    wall, wall_finish = timed_drive(pipe, frames, gts, warmup, feed, window)
    return pipe, [c for c in cycles if c], wall, wall_finish, odo


def building_counts(backend):
    """Buildings, building vertices, level-1 keyframe<->building edges and
    global-prior keyframes of a backend's graph."""
    mgr = backend.buildings_manager
    bnodes = {b.node_id for b in mgr.get_building_nodes()}
    kf = {k.node_id for k in backend.keyframes}
    edges = backend.graph.edges
    kb = sum(1 for e in edges if e["type"] == "se2" and e["level"] == 1
             and {e["i"], e["j"]} & kf and {e["i"], e["j"]} & bnodes)
    priors = sum(1 for e in edges if e["type"] == "xy" and e["level"] == 0)
    return len(mgr.buildings), len(bnodes), kb, priors


def drive_record(backend, field):
    """One keyframe field of every keyframe as bytes (None kept), for a
    bitwise comparison of two drives."""
    return [None if getattr(k, field) is None else np.asarray(getattr(k, field)).tobytes()
            for k in backend.keyframes]


# ------------------------------------------- the reference's own trajectories
# tests/data/reference_drives.npz holds the JAX package's drives of phases 4,
# 7, 8, 10, 11, 13 and 14 on the CPU (scripts/reference_drives.py). The
# helpers below read either package's pipeline with numpy only, so the
# script records the reference with them and this run holds the card's
# drives to that record.

REFERENCE_FILE = "tests/data/reference_drives.npz"
REFERENCE_DRIVES = ("lap", "lap_no_loops", "city", "city_no_buildings", "hdl_400",
                    "front", "front_ndt_omp", "front_fast_vgicp", "front_dense",
                    "lap_ndt_loops", "hdl_imu", "city_resumed", "multibag_voxel")
REF_POSITION_M = 0.02     # every keyframe (front-end drives: frame) position
REF_YAW_RAD = 1e-3        # every keyframe yaw (front-end drives: rotation)
REF_ATE_M = 0.005         # |ATE - ATE of the reference|
ODOM_PART_M = 1e-3        # the first frame whose odometry parts by more


def pose_table(backend):
    """(V, 3) SE2 pose of every graph vertex, of the delta or the hdl
    backend of either package."""
    return np.asarray(backend.poses2d if hasattr(backend, "poses2d") else backend.poses,
                      np.float64).reshape(-1, 3)


def graph_keyframes(backend):
    return [k for k in backend.keyframes if k.node_id is not None]


def loop_edge_pairs(backend):
    """(i, j) of every SE2 / SE3 edge between non-consecutive keyframes."""
    nodes = [k.node_id for k in graph_keyframes(backend)]
    consecutive = {frozenset(p) for p in zip(nodes[1:], nodes[:-1])}
    kf = set(nodes)
    return [(e["i"], e["j"]) for e in backend.graph.edges
            if e["type"] in ("se2", "se3") and e["i"] in kf and e["j"] in kf
            and frozenset((e["i"], e["j"])) not in consecutive]


def building_vertices(backend):
    mgr = getattr(backend, "buildings_manager", None)
    return mgr.get_building_nodes() if mgr is not None else []


def trace_drive(pipe):
    """Records, into ``pipe.drive_trace``, the odometry pose of every frame
    and, after every update step that ran, the frames fed so far, the
    keyframe poses and the step's stats."""
    tr = pipe.drive_trace = {"odom": [], "cycles": [], "poses": [], "frames": [],
                             "buildings": []}
    step, matching = pipe.backend.optimization_step, pipe.odometry.matching

    def traced_step():
        out = step()
        if out:
            be = pipe.backend
            table = pose_table(be)
            tr["cycles"].append(dict(out))
            tr["poses"].append(table[[k.node_id for k in graph_keyframes(be)]])
            tr["frames"].append(len(tr["odom"]))
            tr["buildings"].append(table[[b.node_id for b in building_vertices(be)]])
        return out

    def traced_matching(*a, **kw):
        frame = matching(*a, **kw)
        tr["odom"].append(np.asarray(frame.pose, np.float64))
        return frame

    pipe.backend.optimization_step = traced_step
    pipe.odometry.matching = traced_matching


def trace_resumed(pipe, trace):
    """Traces ``pipe`` (trace_drive) on from ``trace``, the drive of the
    pipeline that saved the checkpoint ``pipe`` loaded: its arrays then
    cover both halves."""
    trace_drive(pipe)
    for k, v in trace.items():
        pipe.drive_trace[k].extend(v)


def drive_arrays(pipe):
    """A traced drive (after finish()) as the arrays of one drive of
    REFERENCE_FILE."""
    be, tr = pipe.backend, pipe.drive_trace
    table = pose_table(be)
    kfs = graph_keyframes(be)
    bnodes = building_vertices(be)
    m = pipe.evaluate()
    nan = float("nan")
    cycles = tr["cycles"]
    return {
        "kf_stamps": np.array([k.stamp for k in kfs], np.float64),
        "kf_poses": table[[k.node_id for k in kfs]].reshape(-1, 3),
        "cycle_frames": np.array(tr["frames"], np.int64),
        "cycle_keyframes": np.array([len(p) for p in tr["poses"]], np.int64),
        "cycle_poses": np.concatenate(tr["poses"] or [np.zeros((0, 3))]),
        "cycle_buildings": np.array([len(p) for p in tr["buildings"]], np.int64),
        "cycle_building_poses": np.concatenate(tr["buildings"] or [np.zeros((0, 3))]),
        "chi2": np.array([[c.get("chi2_level0", c.get("chi2", nan)),
                           c.get("chi2_level1", nan)] for c in cycles],
                         np.float64).reshape(-1, 2),
        "lm_iters": np.array([c.get("lm_iters", -1) for c in cycles], np.int64),
        "odom": np.stack(tr["odom"]).astype(np.float64),
        "loop_edges": np.array(loop_edge_pairs(be), np.int64).reshape(-1, 2),
        "building_ids": np.array([str(b.id) for b in bnodes], dtype=np.str_),
        "building_nodes": np.array([b.node_id for b in bnodes], np.int64),
        "building_poses": table[[b.node_id for b in bnodes]].reshape(-1, 3),
        "metrics": np.array([m["ATE_mean"], m["t_RPE_mean"], m["r_RPE_mean"]],
                            np.float64),
    }


def front_arrays(odo):
    """The odometry frames of a drive without a traced backend (phase 4's,
    11's and 13's front ends) as the arrays of one drive of
    REFERENCE_FILE: every frame's pose, GN iterations and convergence."""
    return {"odom": np.stack([np.asarray(f.pose, np.float64) for f in odo]),
            "iters": np.array([f.iterations for f in odo], np.int64),
            "converged": np.array([f.converged for f in odo], bool)}


def load_reference(path=None):
    """{drive: {field: array}} and the file's meta fields."""
    path = Path(path or Path(__file__).resolve().parent / REFERENCE_FILE)
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    drives = {d: {k.split(".", 1)[1]: v for k, v in flat.items() if k.startswith(d + ".")}
              for d in REFERENCE_DRIVES}
    meta = {k.split(".", 1)[1]: v for k, v in flat.items() if k.startswith("meta.")}
    return drives, meta


def _wrap_angle(a):
    return (a + np.pi) % (2 * np.pi) - np.pi


def rotation_angle(R):
    """(...) rotation angles of (..., 3, 3) rotations, from the skew part
    and the trace together (arccos of the trace alone reads a float32
    rotation's departure from orthonormality, ~1e-7, as ~5e-4 rad)."""
    s = np.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                  R[..., 1, 0] - R[..., 0, 1]], -1)
    return np.arctan2(np.linalg.norm(s, axis=-1) / 2.0,
                      (np.trace(R, axis1=-2, axis2=-1) - 1.0) / 2.0)


def compare_odometry(got, want):
    """``got`` against ``want`` (front_arrays of two drives of the same
    frames, or multibag_voxel's (steps, bags) arrays): every pose's position
    gap and the angle of its relative rotation, the largest of each with
    its frame, the first frame whose position parts by more than
    ODOM_PART_M, and the frames whose GN iteration counts differ (where
    both hold them)."""
    shape = want["odom"].shape[:-2]
    out = {"frames": (got["odom"].shape[:-2], shape)}
    if got["odom"].shape != want["odom"].shape:
        return out
    g, w = got["odom"].reshape(-1, 4, 4), want["odom"].reshape(-1, 4, 4)
    dp = np.linalg.norm(g[:, :3, 3] - w[:, :3, 3], axis=1)
    dr = rotation_angle(np.einsum("nji,njk->nik", g[:, :3, :3], w[:, :3, :3]))
    parted = np.flatnonzero(dp > ODOM_PART_M)

    def at(i):
        return [int(k) for k in np.unravel_index(i, shape)]

    out.update(position_gap=float(dp.max()), position_gap_at=at(dp.argmax()),
               rotation_gap=float(dr.max()), rotation_gap_at=at(dr.argmax()),
               parts_at=at(parted[0]) if len(parted) else None)
    if "iters" in got and "iters" in want:
        out["iterations_differ"] = int((got["iters"] != want["iters"]).sum())
    return out


def compare_drive(got, want):
    """``got`` against ``want`` (drive_arrays of two drives of the same
    frames): keyframe stamps and poses after finish(), loop edges,
    building vertices and their poses, the odometry of every frame, ATE."""
    out = {"stamps_equal": bool(np.array_equal(got["kf_stamps"], want["kf_stamps"])),
           "keyframes": (len(got["kf_stamps"]), len(want["kf_stamps"])),
           "loop_edges": (len(got["loop_edges"]), len(want["loop_edges"])),
           "loop_edges_equal": bool(np.array_equal(got["loop_edges"], want["loop_edges"])),
           "building_vertices": (len(got["building_nodes"]), len(want["building_nodes"])),
           "building_ids_equal": bool(np.array_equal(got["building_ids"],
                                                     want["building_ids"]))}
    if out["stamps_equal"] and len(got["kf_poses"]):
        g, w = got["kf_poses"], want["kf_poses"]
        dp = np.linalg.norm(g[:, :2] - w[:, :2], axis=1)
        dy = np.abs(_wrap_angle(g[:, 2] - w[:, 2]))
        out.update(position_gap=float(dp.max()), position_gap_kf=int(dp.argmax()),
                   yaw_gap=float(dy.max()), yaw_gap_kf=int(dy.argmax()))
    nf = min(len(got["odom"]), len(want["odom"]))
    dt = np.linalg.norm(got["odom"][:nf, :3, 3] - want["odom"][:nf, :3, 3], axis=1)
    parted = np.flatnonzero(dt > ODOM_PART_M)
    out.update(odom_frames=nf, odom_gap=float(dt.max()) if nf else 0.0,
               odom_parts_at=int(parted[0]) if len(parted) else None)
    if len(want["building_nodes"]) and np.array_equal(got["building_ids"],
                                                      want["building_ids"]):
        out["building_gap"] = float(np.linalg.norm(
            got["building_poses"][:, :2] - want["building_poses"][:, :2], axis=1).max())
    out["ate"] = (float(got["metrics"][0]), float(want["metrics"][0]))
    return out


def reference_failures(c):
    """What of compare_drive's or compare_odometry's result misses this
    run's parity bounds."""
    if "stamps_equal" not in c:
        if "position_gap" not in c:
            return [f"poses of shape {c['frames'][0]} against {c['frames'][1]}"]
        bad = []
        if c["position_gap"] > REF_POSITION_M:
            bad.append(f"frame {c['position_gap_at']} {c['position_gap']:.4f} m off")
        if c["rotation_gap"] > REF_YAW_RAD:
            bad.append(f"frame {c['rotation_gap_at']} rotation {c['rotation_gap']:.2e} "
                       "rad off")
        return bad
    bad = []
    if not c["stamps_equal"]:
        bad.append(f"keyframe stamps differ ({c['keyframes'][0]} against "
                   f"{c['keyframes'][1]} keyframes)")
    if not c["loop_edges_equal"]:
        bad.append(f"loop edges differ ({c['loop_edges'][0]} against "
                   f"{c['loop_edges'][1]})")
    if not c["building_ids_equal"]:
        bad.append(f"building vertices differ ({c['building_vertices'][0]} against "
                   f"{c['building_vertices'][1]})")
    if abs(c["ate"][0] - c["ate"][1]) > REF_ATE_M:
        bad.append(f"ATE {c['ate'][0]:.6f} m against {c['ate'][1]:.6f} m")
    if c.get("position_gap", 0.0) > REF_POSITION_M:
        bad.append(f"keyframe {c['position_gap_kf']} {c['position_gap']:.4f} m off")
    if c.get("yaw_gap", 0.0) > REF_YAW_RAD:
        bad.append(f"keyframe {c['yaw_gap_kf']} yaw {c['yaw_gap']:.2e} rad off")
    return bad


def odometry_summary(c):
    """compare_odometry's result as one line."""
    if "position_gap" not in c:
        return f"poses of shape {c['frames'][0]} against {c['frames'][1]}"
    parts = ("no pose parts by more than 1 mm" if c["parts_at"] is None
             else f"the poses part by more than 1 mm at {c['parts_at']}")
    return (f"largest position gap {c['position_gap']:.6f} m at {c['position_gap_at']}, "
            f"rotation gap {c['rotation_gap']:.3e} rad at {c['rotation_gap_at']}; {parts}; "
            f"GN iteration counts differ at {c.get('iterations_differ')} of "
            f"{int(np.prod(c['frames'][1]))}")


def drive_summary(c):
    """compare_drive's result as one line."""
    gap = (f"largest keyframe position gap {c['position_gap']:.6f} m at keyframe "
           f"{c['position_gap_kf']}, yaw gap {c['yaw_gap']:.3e} rad at keyframe "
           f"{c['yaw_gap_kf']}" if "position_gap" in c else "keyframes not comparable")
    parts = ("no frame's odometry parts by more than 1 mm" if c["odom_parts_at"] is None
             else f"odometry parts by more than 1 mm at frame {c['odom_parts_at']}")
    return (f"{gap}; {parts} (largest {c['odom_gap']:.3e} m over {c['odom_frames']} "
            f"frames); ATE {c['ate'][0]:.6f} m, reference {c['ate'][1]:.6f} m; keyframes "
            f"{c['keyframes']}, loop edges {c['loop_edges']}, building vertices "
            f"{c['building_vertices']}")


def held_to_reference(name, got, reference, report):
    """Prints the drive ``name`` (a traced pipeline, or the arrays of a drive)
    against the reference's record of the same frames and returns what
    misses the bounds: compare_drive where the record has a backend,
    compare_odometry where it holds odometry only."""
    want = reference[name]
    if "kf_stamps" in want:
        c = compare_drive(got if isinstance(got, dict) else drive_arrays(got), want)
        line = drive_summary(c)
    else:
        c = compare_odometry(got, want)
        line = odometry_summary(c)
    print(f"{name} against the reference: {line}", flush=True)
    bad = reference_failures(c)
    report.setdefault("reference", {})[name] = c | {"misses": bad}
    return [f"{name}: {b}" for b in bad]


def city_frames(seed=0, n_frames=CITY_WARMUP + CITY_FRAMES):
    """bench.py:45-60's city drive: (world, frames, ground truth re-anchored
    at the first frame as bench.py:80-95). ``seed`` selects the world and the
    scans; REFERENCE_FILE holds the drives of seed 0 and the default
    ``n_frames``."""
    from delta_graph_slam_tpu_torch.io.lidar_sim import raycast_city_sequence

    t0 = time.perf_counter()
    world, frames = raycast_city_sequence(n_frames=n_frames, seed=seed,
                                          speed=3.0, gps_noise_std=0.5,
                                          gps_walk_std=0.15)
    print(f"generated {len(frames)} frames in {time.perf_counter() - t0:.1f} s",
          flush=True)
    return world, frames, rel_gt(frames)


def threefry_draws(report):
    """The reference's random stream on the card (utils/prng.py): one
    keyframe's line draws (the chain's key split, the sub-key split per
    line, (n_hypotheses, 2) uniforms a line) and one frame's floor draw of
    hdl_400, bitwise against the CPU over 3 draws, then timed (CUDA events)
    with their CUDA kernels counted by torch.profiler."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from delta_graph_slam_tpu_torch.config import get_preset
    from delta_graph_slam_tpu_torch.utils.prng import KeyChain, split, uniform

    sm = get_preset("delta").delta.scanmatcher
    n_floor = get_preset("hdl_400").floor.n_hypotheses
    draws = {
        "lines": (7, lambda key: uniform(split(key, sm.max_lines), (sm.n_hypotheses, 2))),
        "floor": (42, lambda key: uniform(key, (n_floor, 3))),
    }
    out = {}
    for name, (seed, draw) in draws.items():
        card, host = KeyChain(seed, "cuda"), KeyChain(seed, "cpu")
        same = all(torch.equal(draw(card.next()).cpu(), draw(host.next()))
                   for _ in range(3))
        ms = cuda_ms(lambda: draw(card.next()))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            draw(card.next())
            torch.cuda.synchronize()
        kernels = sum(e.count for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA)
        out[name] = {"ms": ms, "kernels": kernels, "bitwise_cpu": same}
        print(f"threefry, one {name} draw: {ms:.4f} ms, {kernels} CUDA kernels, "
              f"bitwise equal to the CPU {same}", flush=True)
        check(same, f"the {name} draw on the card differs from the CPU's")
    out["power_limit"] = smi("power.limit")
    report["threefry"] = out


def run_buildings(report, world, frames, gts, reference):
    import tempfile

    from delta_graph_slam_tpu_torch.io.pcd import load_pcd
    from delta_graph_slam_tpu_torch.ops import nn_kernel

    nn_kernel.launches = 0
    pipe, cycles, wall, wall_finish, odo = city_drive(world, frames, gts)
    launches = nn_kernel.launches
    be = pipe.backend
    m = pipe.evaluate()
    n_b, n_bv, n_kb, n_priors = building_counts(be)
    t = pipe.timing_summary()

    def ms(k):
        return t[k]["mean_ms"] if k in t else float("nan")

    stages = ["get_buildings", "align_global", "building_nodes", "align_local",
              "overlap_test", "align_overlapped", "optimize_level0", "optimize_level1",
              "optimize_level2"]
    per_call = {k: ms("backend." + k) for k in stages}
    per_call["optimization_step"] = ms("optimization_step")
    rounds = [c["deoverlap_rounds"] for c in cycles]
    chi2 = [(c["chi2_level0"], c["chi2_level1"]) for c in cycles]
    in_range = [k for k in be.keyframes if k.near_buildings]
    aligned = [k for k in in_range if k.global_alignment is not None]
    print(f"{CITY_FRAMES} frames in {wall:.3f} s: {CITY_FRAMES / wall:.3f} frames/s; "
          f"keyframes {len(be.keyframes)} ({len(in_range)} with buildings in range, "
          f"{len(aligned)} globally aligned), cycles {len(cycles)}", flush=True)
    print("ms per call: " + ", ".join(f"{k} {v:.3f}" for k, v in per_call.items()),
          flush=True)
    print(f"buildings {n_b}, building vertices {n_bv}, keyframe<->building edges "
          f"{n_kb}, global priors {n_priors}, nn1 launches {launches}", flush=True)
    print(f"de-overlap rounds per cycle {rounds}", flush=True)

    with tempfile.TemporaryDirectory() as d:
        saved = pipe.save_map(d)
        pcd = {n: len(load_pcd(Path(d) / n)) if (Path(d) / n).exists() else 0
               for n in ("map.pcd", "b_map.pcd", "aligned_b_map.pcd")}
    print(f"save_map: {saved}, points {pcd}", flush=True)

    # the same frames again: the drive must repeat bit for bit
    pipe_2, cycles_2, wall_2, _, _ = city_drive(world, frames, gts)
    same = {
        "poses": np.array_equal(be.poses, pipe_2.backend.poses),
        "odom": drive_record(be, "odom") == drive_record(pipe_2.backend, "odom"),
        "estimated_odom": drive_record(be, "estimated_odom")
        == drive_record(pipe_2.backend, "estimated_odom"),
        "chi2": chi2 == [(c["chi2_level0"], c["chi2_level1"]) for c in cycles_2],
        "ate": m["ATE_mean"] == pipe_2.evaluate()["ATE_mean"],
    }
    print(f"the drive twice: bitwise equal {same} ({CITY_FRAMES / wall_2:.3f} "
          "frames/s the second time)", flush=True)

    pipe_n, _, wall_n, _, _ = city_drive(world, frames, gts, buildings=False)
    m_n = pipe_n.evaluate()
    misses = (held_to_reference("city", pipe, reference, report)
              + held_to_reference("city_no_buildings", pipe_n, reference, report))
    print("ATE {ATE_mean:.4f} m (std {ATE_std:.4f}), t-RPE {t_RPE_mean:.4f} m, "
          "r-RPE {r_RPE_mean:.5f} rad".format(**m)
          + f"; no_buildings ATE {m_n['ATE_mean']:.4f} m "
          f"({CITY_FRAMES / wall_n:.3f} frames/s)", flush=True)
    report["buildings"] = {
        "frames": CITY_FRAMES, "warmup_frames": CITY_WARMUP, "wall_s": wall,
        "frames_per_s": CITY_FRAMES / wall, "keyframes": len(be.keyframes),
        "keyframes_in_range": len(in_range), "keyframes_aligned": len(aligned),
        "buildings": n_b, "building_vertices": n_bv, "kf_building_edges": n_kb,
        "global_priors": n_priors, "deoverlap_rounds": rounds, "chi2": chi2,
        "nn1_launches": launches, "ms_per_call": per_call, "timing": t,
        "metrics": m, "pcd_points": pcd, "no_buildings_metrics": m_n,
        "no_buildings_frames_per_s": CITY_FRAMES / wall_n,
        "repeat_bitwise_equal": same, "repeat_frames_per_s": CITY_FRAMES / wall_2,
    }
    check(n_bv >= 3, f"{n_bv} building vertices, need 3")
    check(n_kb >= 1, "no keyframe<->building edge")
    check(n_priors >= 1, "no global-alignment prior")
    check(in_range and len(aligned) == len(in_range),
          f"align_global ran on {len(aligned)} of {len(in_range)} keyframes with "
          "buildings in range")
    check(cycles and all(np.isfinite(c).all() for c in chi2),
          f"chi2 not finite on every cycle: {chi2}")
    check(max(rounds) <= 15, f"de-overlap rounds {rounds} above 15")
    check(m["ATE_mean"] <= 1.0, f"ATE {m['ATE_mean']} m > 1.0 m")
    check(saved and all(n > 0 for n in pcd.values()), f"save_map wrote {pcd}")
    check(all(same.values()), f"two drives of the same frames differ: {same}")
    check(not misses, f"the city drives against the reference: {misses}")
    return launches, serial_record(pipe, wall, wall_finish, odo)


def serial_record(pipe, wall, wall_finish, odo):
    """What phase 12 holds a threaded drive against: keyframe stamps, the
    odometry of every frame, and the timings."""
    return {"stamps": [k.stamp for k in pipe.backend.keyframes], "odo": odo,
            "wall": wall, "wall_finish": wall_finish,
            "timing": pipe.timing_summary(), "ate": pipe.evaluate()["ATE_mean"]}


# ---------------------------------------------------------- SE3 graph solve
# float64 numpy twins of the SE3 edge math, independent of the port
# (bench.py:755-953), for the graph's construction and the host oracle

def _hat(v):
    H = np.zeros((len(v), 3, 3))
    H[:, 0, 1], H[:, 0, 2] = -v[:, 2], v[:, 1]
    H[:, 1, 0], H[:, 1, 2] = v[:, 2], -v[:, 0]
    H[:, 2, 0], H[:, 2, 1] = -v[:, 1], v[:, 0]
    return H


def _q_to_R(q):
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    R = np.empty((len(q), 3, 3))
    R[:, 0] = np.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], 1)
    R[:, 1] = np.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], 1)
    R[:, 2] = np.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], 1)
    return R


def _R_to_q(R):
    """Batched rotation -> quaternion (wxyz), w >= 0 (bench.py:779-809)."""
    q = np.empty((len(R), 4))
    t = np.einsum("eii->e", R)
    c0 = t > 0
    m = np.argmax(np.stack([R[:, 0, 0], R[:, 1, 1], R[:, 2, 2]], 1), axis=1)
    s = np.sqrt(np.maximum(t[c0] + 1.0, 1e-12)) * 2
    q[c0] = np.stack([0.25 * s, (R[c0, 2, 1] - R[c0, 1, 2]) / s,
                      (R[c0, 0, 2] - R[c0, 2, 0]) / s,
                      (R[c0, 1, 0] - R[c0, 0, 1]) / s], 1)
    for i in range(3):
        j, k = (i + 1) % 3, (i + 2) % 3
        sel = (~c0) & (m == i)
        if not sel.any():
            continue
        s = np.sqrt(np.maximum(1.0 + R[sel, i, i] - R[sel, j, j] - R[sel, k, k],
                               1e-12)) * 2
        q[sel, 0] = (R[sel, k, j] - R[sel, j, k]) / s
        q[sel, 1 + i] = 0.25 * s
        q[sel, 1 + j] = (R[sel, j, i] + R[sel, i, j]) / s
        q[sel, 1 + k] = (R[sel, k, i] + R[sel, i, k]) / s
    q[q[:, 0] < 0] *= -1.0
    return q


def _se3_exp_np(d):
    """Batched se3 exp, d (E,6) = [rho, phi] -> (R (E,3,3), t (E,3))."""
    rho, phi = d[:, :3], d[:, 3:]
    th = np.maximum(np.linalg.norm(phi, axis=1), 1e-12)[:, None, None]
    H = _hat(phi / th[:, :, 0])
    eye = np.broadcast_to(np.eye(3), H.shape)
    R = eye + np.sin(th) * H + (1 - np.cos(th)) * (H @ H)
    V = eye + ((1 - np.cos(th)) / th) * H + ((th - np.sin(th)) / th) * (H @ H)
    small = th[:, 0, 0] < 1e-7
    R[small] = np.eye(3) + _hat(phi[small])
    V[small] = np.eye(3) + 0.5 * _hat(phi[small])
    return R, (V @ rho[:, :, None])[:, :, 0]


def _pose7_oplus_np(p, d):
    """Right-multiplicative pose update, the quaternion renormalized."""
    R = _q_to_R(p[:, 3:7])
    Re, te = _se3_exp_np(d)
    q = _R_to_q(R @ Re)
    return np.concatenate([p[:, :3] + (R @ te[:, :, None])[:, :, 0],
                           q / np.linalg.norm(q, axis=1, keepdims=True)], 1)


def _plane_azel(n):
    xy2 = n[:, 0] ** 2 + n[:, 1] ** 2
    safe = xy2 > 1e-20
    az = np.where(safe, np.arctan2(np.where(safe, n[:, 1], 0.0),
                                   np.where(safe, n[:, 0], 1.0)), 0.0)
    el = np.where(safe, np.arctan2(n[:, 2], np.sqrt(np.maximum(xy2, 1e-30))),
                  np.where(n[:, 2] >= 0, np.pi / 2, -np.pi / 2))
    return az, el


def _plane_rotation_np(n):
    az, el = _plane_azel(n)
    ca, sa, ce, se = np.cos(az), np.sin(az), np.cos(el), np.sin(el)
    R = np.empty((len(n), 3, 3))
    R[:, 0] = np.stack([ca * ce, -sa, -ca * se], 1)
    R[:, 1] = np.stack([sa * ce, ca, -sa * se], 1)
    R[:, 2] = np.stack([se, np.zeros_like(ca), ce], 1)
    return R


def _plane_oplus_np(c, d):
    s, cc = np.sin(d[:, 1]), np.cos(d[:, 1])
    n_local = np.stack([cc * np.cos(d[:, 0]), cc * np.sin(d[:, 0]), s], 1)
    n_new = (_plane_rotation_np(c[:, :3]) @ n_local[:, :, None])[:, :, 0]
    out = np.concatenate([n_new, (c[:, 3] - d[:, 2])[:, None]], 1)
    return out / np.maximum(np.linalg.norm(out[:, :3], axis=1, keepdims=True), 1e-12)


def _err_se3_plane_np(poses, plane, meas):
    """(T^-1 plane).ominus(meas) over edges: poses (E,7), plane (E,4), meas (E,4)."""
    RT = np.swapaxes(_q_to_R(poses[:, 3:7]), 1, 2)
    n2 = (RT @ plane[:, :3, None])[:, :, 0]
    tinv = -(RT @ poses[:, :3, None])[:, :, 0]
    w2 = plane[:, 3] - np.sum(tinv * n2, axis=1)
    nm = (np.swapaxes(_plane_rotation_np(n2), 1, 2) @ meas[:, :3, None])[:, :, 0]
    az, el = _plane_azel(nm)
    return np.stack([az, el, (-w2) - (-meas[:, 3])], 1)


def _se3_host_linearize(x, ei, ej, meas):
    """EdgeSE3 residual and analytic Jacobians (right-multiplicative oplus),
    float64 numpy (bench.py:900-928)."""
    pi, pj = x[ei], x[ej]
    RiT = np.swapaxes(_q_to_R(pi[:, 3:7]), 1, 2)
    RzT = np.swapaxes(_q_to_R(meas[:, 3:7]), 1, 2)
    trel = (RiT @ (pj[:, :3] - pi[:, :3])[:, :, None])[:, :, 0]
    Rrel = RiT @ _q_to_R(pj[:, 3:7])
    td = (RzT @ (trel - meas[:, :3])[:, :, None])[:, :, 0]
    Rd = RzT @ Rrel
    q = _R_to_q(Rd)
    Q = 0.5 * (q[:, 0][:, None, None] * np.eye(3) + _hat(q[:, 1:4]))
    Ji = np.zeros((len(ei), 6, 6))
    Ji[:, :3, :3] = -RzT
    Ji[:, :3, 3:] = RzT @ _hat(trel)
    Ji[:, 3:, 3:] = -(Q @ np.swapaxes(Rrel, 1, 2))
    Jj = np.zeros((len(ei), 6, 6))
    Jj[:, :3, :3] = Rd
    Jj[:, 3:, 3:] = Q
    return np.concatenate([td, q[:, 1:4]], 1), Ji, Jj


def _se3_plane_host_linearize(x, plane, pe, meas, h=1e-6):
    """EdgeSE3Plane residual and NUMERIC Jacobians (central differences in
    the vertices' local charts), as g2o takes them for its custom edges
    (bench.py:931-953)."""
    poses = x[pe]
    pl = np.broadcast_to(plane, (len(pe), 4))
    r = _err_se3_plane_np(poses, pl, meas)
    Jp = np.zeros((len(pe), 3, 6))
    for d in range(6):
        dv = np.zeros((len(pe), 6))
        dv[:, d] = h
        Jp[:, :, d] = (_err_se3_plane_np(_pose7_oplus_np(poses, dv), pl, meas)
                       - _err_se3_plane_np(_pose7_oplus_np(poses, -dv), pl, meas)) / (2 * h)
    Jl = np.zeros((len(pe), 3, 3))
    for d in range(3):
        dv = np.zeros((len(pe), 3))
        dv[:, d] = h
        Jl[:, :, d] = (_err_se3_plane_np(poses, _plane_oplus_np(pl, dv), meas)
                       - _err_se3_plane_np(poses, _plane_oplus_np(pl, -dv), meas)) / (2 * h)
    return r, Jp, Jl


SE3_INFO = np.diag([100.0] * 3 + [400.0] * 3)
PLANE_INFO = np.diag([1.0, 1.0, 10.0])


def bench_graph_se3(n_nodes, rng_seed=7, plane_every=4, n_laps=2):
    """The hdl graph of bench.py:956-1025 in numpy: ``n_laps`` laps of a 3-D
    circle, noisy SE3 odometry (0.01 m, 0.002 rad in all 6 dof), vertices
    initialized by integrating it, Huber loop closures every 100 nodes
    between laps, the z = 0 floor seen from every ``plane_every``-th
    keyframe, one xyz prior on vertex 1.

    Returns (init (n,7), se3 edges [(i, j, meas7, kernel)], plane edges
    [(i, coeffs4)], (vertex, xyz) of the prior, gt (n,7))."""
    rng = np.random.default_rng(rng_seed)
    lap = n_nodes // n_laps
    th = 2.0 * np.pi / lap * np.arange(n_nodes)
    radius = lap / (2 * np.pi)
    gt = np.stack([radius * np.sin(th), radius * (1 - np.cos(th)), 0 * th,
                   np.cos(th / 2), 0 * th, 0 * th, np.sin(th / 2)], 1)

    def rel7(a, b):
        Ra, Rb = _q_to_R(a[None, 3:7])[0], _q_to_R(b[None, 3:7])[0]
        return np.concatenate([Ra.T @ (b[:3] - a[:3]), _R_to_q((Ra.T @ Rb)[None])[0]])

    def noisy(m, s_t, s_r):
        d = np.concatenate([rng.normal(0, s_t, 3), rng.normal(0, s_r, 3)])
        return _pose7_oplus_np(m[None], d[None])[0]

    meas = [noisy(rel7(gt[k], gt[k + 1]), 0.01, 0.002) for k in range(n_nodes - 1)]
    init = np.zeros((n_nodes, 7))
    init[0] = gt[0]
    for k in range(1, n_nodes):
        Ra = _q_to_R(init[None, k - 1, 3:7])[0]
        init[k, :3] = init[k - 1, :3] + Ra @ meas[k - 1][:3]
        q = _R_to_q((Ra @ _q_to_R(meas[k - 1][None, 3:7])[0])[None])[0]
        init[k, 3:7] = q / np.linalg.norm(q)
    edges = [(k, k + 1, meas[k], "NONE") for k in range(n_nodes - 1)]
    for left in range(0, n_nodes - lap, lap):
        for k in range(left, left + lap - 1, 100):
            edges.append((k, k + lap, noisy(rel7(gt[k], gt[k + lap]), 0.005, 0.001),
                          "Huber"))
    planes = []
    for k in range(0, n_nodes, plane_every):
        R = _q_to_R(gt[None, k, 3:7])[0]
        n_local = R.T @ np.array([0.0, 0.0, 1.0])
        # transform_plane(T^-1, plane): n' = R^T n, w' = w - (-R^T t).n'
        w_local = 0.0 - float(n_local @ (R.T @ (-gt[k, :3])))
        planes.append((k, np.concatenate([n_local, [w_local]])))
    return init, edges, planes, (1, gt[1, :3]), gt


def se3_graph_builder(graph, device):
    """The port's SE3GraphBuilder of a bench_graph_se3 (vertex 0 fixed, one
    floor-plane vertex)."""
    from delta_graph_slam_tpu_torch.graph import SE3GraphBuilder

    init, edges, planes, (pv, pxyz), _ = graph
    b = SE3GraphBuilder(device=device)
    for k, p in enumerate(init):
        b.add_se3_node(p, fixed=(k == 0))
    for i, j, m, kern in edges:
        b.add_se3_edge(i, j, m, SE3_INFO, kernel=kern, delta=1.0)
    p0 = b.add_plane_node([0.0, 0.0, 1.0, 0.0])
    for k, coeffs in planes:
        b.add_se3_plane_edge(k, p0, coeffs, PLANE_INFO)
    b.add_se3_prior_xyz_edge(pv, pxyz, np.eye(3) * 10)
    return b


def host_lm_se3(builder, max_iters):
    """Float64 robust LM on the host for the SE3 graph, the oracle of
    bench.py:1178 (bench_pose_graph_se3_cpu): analytic EdgeSE3 Jacobians,
    numeric EdgeSE3Plane ones, Huber on flagged edges, g2o's gain-ratio
    lambda schedule from 1e-5 * 400, scipy SuperLU, vertex 0 clamped, the
    plane's 3 dims at the tail. Returns (seconds, iterations, chi2, poses)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl

    def table(etype, *keys):
        es = [e for e in builder.edges if e["type"] == etype]
        return [np.asarray([e[k] for e in es]) for k in keys]

    ei, ej, meas, infos, kern, delta = table("se3", "i", "j", "meas", "info",
                                             "kernel", "delta")
    huber = kern == 1
    pe, pmeas, pinfo = table("se3plane", "i", "meas", "info")
    xi, xmeas, xinfo = table("xyz", "i", "meas", "info")
    x = np.stack(builder.poses).astype(np.float64)
    plane = np.asarray(builder.planes[0], np.float64)
    V = len(x)
    NP = 6 * V + 3
    tail = 6 * V + np.arange(3)

    def idx(rows, cols):
        """Flat (row, col) indices of blocks at dof offsets rows (E,r) x cols (E,c)."""
        shape = (len(rows), rows.shape[1], cols.shape[1])
        return (np.broadcast_to(rows[:, :, None], shape).ravel(),
                np.broadcast_to(cols[:, None, :], shape).ravel())

    def dof(v, n=6):
        return 6 * v[:, None] + np.arange(n)

    tails = np.broadcast_to(tail, (len(pe), 3))
    pattern = [idx(dof(ei), dof(ei)), idx(dof(ei), dof(ej)), idx(dof(ej), dof(ei)),
               idx(dof(ej), dof(ej)), idx(dof(pe), dof(pe)), idx(dof(pe), tails),
               idx(tails, dof(pe)), idx(tails, tails), idx(dof(xi, 3), dof(xi, 3)),
               (np.arange(6), np.arange(6))]
    rows = np.concatenate([p[0] for p in pattern])
    cols = np.concatenate([p[1] for p in pattern])

    def robust(r):
        e2 = np.einsum("ea,eab,eb->e", r, infos, r)
        out = huber & (e2 > delta ** 2)
        sq = np.sqrt(np.maximum(e2, 1e-30))
        return (np.where(out, 2 * delta * sq - delta ** 2, e2).sum(),
                np.where(out, delta / sq, 1.0))

    def total_chi2(x, plane):
        rho = robust(_se3_host_linearize(x, ei, ej, meas)[0])[0]
        rp = _err_se3_plane_np(x[pe], np.broadcast_to(plane, (len(pe), 4)), pmeas)
        rx = x[xi, :3] - xmeas
        return (rho + np.einsum("ea,eab,eb->e", rp, pinfo, rp).sum()
                + np.einsum("ea,eab,eb->e", rx, xinfo, rx).sum())

    t0 = time.perf_counter()
    lam, nu, it = 1e-5 * 400.0, 2.0, 0
    chi2 = total_chi2(x, plane)
    while it < max_iters:
        r, Ji, Jj = _se3_host_linearize(x, ei, ej, meas)
        Wf = infos * robust(r)[1][:, None, None]
        rp, Jp, Jl = _se3_plane_host_linearize(x, plane, pe, pmeas)
        rx = x[xi, :3] - xmeas
        Jx = _q_to_R(x[xi, 3:7])        # d t / d rho = R (right-multiplicative)
        JiT_W = np.einsum("eba,ebc->eac", Ji, Wf)
        JjT_W = np.einsum("eba,ebc->eac", Jj, Wf)
        JpT_W = np.einsum("eba,ebc->eac", Jp, pinfo)
        JlT_W = np.einsum("eba,ebc->eac", Jl, pinfo)
        JxT_W = np.einsum("eba,ebc->eac", Jx, xinfo)
        vals = np.concatenate([m.ravel() for m in (
            JiT_W @ Ji, JiT_W @ Jj, JjT_W @ Ji, JjT_W @ Jj, JpT_W @ Jp,
            JpT_W @ Jl, JlT_W @ Jp, JlT_W @ Jl, JxT_W @ Jx, np.full(6, 1e12))])
        bvec = np.zeros(NP)
        for at, g in ((dof(ei), np.einsum("eab,eb->ea", JiT_W, r)),
                      (dof(ej), np.einsum("eab,eb->ea", JjT_W, r)),
                      (dof(pe), np.einsum("eab,eb->ea", JpT_W, rp)),
                      (tails, np.einsum("eab,eb->ea", JlT_W, rp)),
                      (dof(xi, 3), np.einsum("eab,eb->ea", JxT_W, rx))):
            np.add.at(bvec, at.ravel(), g.ravel())
        H = sp.coo_matrix((vals, (rows, cols)), shape=(NP, NP)).tocsc()
        # minimum degree on A^T + A: COLAMD's order fills in around the
        # plane's dense rows and takes several times as long
        dx = spl.splu(H + sp.identity(NP, format="csc") * lam,
                      permc_spec="MMD_AT_PLUS_A").solve(-bvec)
        xt = _pose7_oplus_np(x, dx[:6 * V].reshape(V, 6))
        plt = _plane_oplus_np(plane[None], dx[6 * V:][None])[0]
        chi2_t = total_chi2(xt, plt)
        rho_g = (chi2 - chi2_t) / max(abs(np.sum(dx * (lam * dx - bvec))), 1e-30)
        if chi2_t < chi2:
            x, plane, chi2 = xt, plt, chi2_t
            lam *= max(1.0 / 3.0, 1.0 - (2 * rho_g - 1) ** 3)
            nu = 2.0
        else:
            lam *= nu
            nu *= 2.0
        it += 1
        if lam > 1e12:
            break
    return time.perf_counter() - t0, it, float(chi2), x


def hub_step_error(g):
    """Relative error of one chain_hub_solve step against a float64 dense
    solve of the same damped system: the graph's first linearization at
    LM's first lambda."""
    import torch

    from delta_graph_slam_tpu_torch.graph import se3_solver
    from delta_graph_slam_tpu_torch.graph.hub_solve import chain_hub_solve
    from delta_graph_slam_tpu_torch.graph.lm_core import (
        dense_solve, diag_blocks, gradient)
    from delta_graph_slam_tpu_torch.ops.segment import deterministic

    g64 = se3_solver._to_f64(g)
    free = se3_solver._free_mask(g64, 0)
    N = free.shape[0]
    with deterministic():
        sys, _ = se3_solver._linearize(g64, se3_solver._state0(g64), 0)
        b = gradient(sys, N)
        dg = torch.diagonal(diag_blocks(sys, N), dim1=-2, dim2=-1)
        lam = 1e-5 * (dg.abs() * free).max()
        n_hub = g.planes.shape[0] + g.points.shape[0]
        x, dropped = chain_hub_solve(
            sys, -b, free, lam, N, n_hub=n_hub, K_cap=64,
            coup_cap=g.se3_plane.i.shape[0] + g.se3_point.i.shape[0])
        ref = dense_solve(sys, -b, free, lam)
    err = float((x - ref).norm() / ref.norm())
    return err, int(dropped), float(lam), N * free.shape[1]


def lm_launches_per_iteration(solve, cfg):
    """CUDA kernels per LM iteration from torch.profiler: the difference of
    two solves capped at 2 and 4 iterations (early exits off), halved.
    None when the profiler shows no device events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    counts = []
    for cap in (2, 4):
        c = dataclasses.replace(cfg, max_iterations=cap, chi2_rel_tol=0.0, dx_tol=0.0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            solve(c)
        counts.append(sum(e.count for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA))
    return (counts[1] - counts[0]) / 2 if counts[0] > 0 else None


def se3_graph_solve(report, n_nodes=GRAPH_NODES, device="cuda"):
    """The hdl bench graph on the card against the host oracle."""
    import torch

    from delta_graph_slam_tpu_torch.graph import SolverConfig, optimize_se3

    graph = bench_graph_se3(n_nodes)
    gt = graph[-1]
    b = se3_graph_builder(graph, device)
    g = b.to_arrays(dtype=np.float32)
    n_off = b.count_offchain()
    cfg = SolverConfig(backend="chain", max_iterations=SE3_LM_ITERS)

    def solve(c):
        out = optimize_se3(g, level=0, config=c, n_offchain=n_off)
        torch.cuda.synchronize()
        return out

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    (s1, st1) = solve(cfg)
    first_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    (s2, st2) = solve(cfg)
    chi2 = [float(s.chi2_final) for s in (st1, st2)]
    same_state = all(bool(torch.equal(a, c)) for a, c in zip(s1, s2))
    poses = s1[0].cpu().numpy().astype(np.float64)
    ate = float(np.mean(np.linalg.norm(poses[:n_nodes, :3] - gt[:, :3], axis=1)))
    dropped = int(st1.n_offchain_dropped)
    print(f"card: chi2 {float(st1.chi2_initial)!r} -> {chi2[0]!r} / {chi2[1]!r} after "
          f"{st1.iterations} / {st2.iterations} iterations (bitwise equal chi2 "
          f"{chi2[0] == chi2[1]}, state {same_state}), ATE {ate:.4f} m, "
          f"n_offchain_dropped {dropped}, off-chain edges {n_off}, first solve "
          f"{first_s:.2f} s, peak device memory {peak / 2**20:.1f} MiB", flush=True)
    check(chi2[0] == chi2[1] and st1.iterations == st2.iterations and same_state,
          f"two SE3 solves of the same graph differ: chi2 {chi2}, iterations "
          f"{st1.iterations}/{st2.iterations}, state equal {same_state}")
    check(dropped == 0, f"the SE3 solve dropped {dropped} off-chain/coupling edges")
    check(np.isfinite(poses).all(), "the SE3 solve returned non-finite poses")

    step_err, step_drop, step_lam, n_dof = hub_step_error(g)
    print(f"one chain_hub_solve step vs a float64 dense solve ({n_dof} dof, lambda "
          f"{step_lam:.4g}): relative error {step_err:.3e} (limit 1e-5), dropped "
          f"{step_drop}", flush=True)
    check(step_err < 1e-5 and step_drop == 0,
          f"hub solve step error {step_err} (dropped {step_drop})")

    # ms/iteration by phase 6's marginal protocol, best of 2
    times = {}
    for cap in (4, 12):
        cfg_c = dataclasses.replace(cfg, max_iterations=cap, chi2_rel_tol=0.0,
                                    dx_tol=0.0)
        best, its = float("inf"), 0
        for _ in range(2):
            t0 = time.perf_counter()
            _, st = solve(cfg_c)
            best = min(best, time.perf_counter() - t0)
            its = st.iterations
        times[cap] = (best, its)
    (t1, i1), (t2, i2) = times[4], times[12]
    ms_iter = (t2 - t1) * 1000.0 / max(i2 - i1, 1)
    launches = lm_launches_per_iteration(solve, cfg)

    th, ih, chi2_h, xh = host_lm_se3(se3_graph_builder(graph, "cpu"), 40)
    ate_h = float(np.mean(np.linalg.norm(xh[:, :3] - gt[:, :3], axis=1)))
    print(f"host float64 LM (scipy SuperLU): chi2 {chi2_h!r} after {ih} iterations "
          f"in {th:.1f} s, ATE {ate_h:.4f} m", flush=True)
    print(f"SE3 LM at {n_nodes} nodes: {ms_iter:.3f} ms/iteration (marginal "
          f"{i1}->{i2} iterations), CUDA kernels per iteration "
          f"{'not measured' if launches is None else launches}, host oracle "
          f"{th * 1000.0 / max(ih, 1):.1f} ms/iteration", flush=True)
    report["se3_graph"] = {
        "nodes": n_nodes, "offchain": n_off, "chi2_initial": float(st1.chi2_initial),
        "chi2": chi2[0], "iterations": st1.iterations, "ate_m": ate,
        "state_bit_identical": same_state, "n_offchain_dropped": dropped,
        "first_solve_s": first_s, "peak_mem_bytes": peak, "ms_per_iter": ms_iter,
        "marginal": times, "kernels_per_iter": launches,
        "hub_step_rel_err": step_err, "hub_step_lambda": step_lam,
        "host_chi2": chi2_h, "host_iterations": ih, "host_ate_m": ate_h, "host_s": th,
    }
    check(np.isfinite(chi2[0]) and chi2[0] <= 1.02 * chi2_h,
          f"card SE3 chi2 {chi2[0]} above 1.02 x the host's {chi2_h}")


def se3_lm_capture(report, n_nodes=GRAPH_NODES, device="cuda"):
    """Phase 9's graph solved for SE3_CAPTURE_ITERS LM iterations (early
    exits off) twice from the same state: every iteration eager, and the
    iteration captured once as a CUDA graph and replayed (optimize_se3's
    default). The states, chi2 and lambda must be equal bit for bit. ms an
    iteration by the marginal protocol (solves capped at 2 and 12
    iterations, best of 3) and CUDA kernels an iteration, both ways."""
    import torch

    from delta_graph_slam_tpu_torch.graph import SolverConfig, optimize_se3

    b = se3_graph_builder(bench_graph_se3(n_nodes), device)
    g = b.to_arrays(dtype=np.float32)
    n_off = b.count_offchain()
    cfg = SolverConfig(backend="chain", max_iterations=SE3_CAPTURE_ITERS,
                       chi2_rel_tol=0.0, dx_tol=0.0)
    out = {}
    for name, cuda_graph in (("eager", False), ("graph", True)):
        def solve(c, cuda_graph=cuda_graph):
            res = optimize_se3(g, level=0, config=c, n_offchain=n_off,
                               cuda_graph=cuda_graph)
            torch.cuda.synchronize()
            return res

        state, st = solve(cfg)
        best = {}
        for cap in (2, 12):
            c = dataclasses.replace(cfg, max_iterations=cap)
            for _ in range(3):
                t0 = time.perf_counter()
                solve(c)
                best[cap] = min(best.get(cap, float("inf")), time.perf_counter() - t0)
        out[name] = dict(state=state, stats=st, ms=(best[12] - best[2]) * 100.0,
                         ms_2=best[2] * 1000.0,
                         kernels=lm_launches_per_iteration(solve, cfg))
    e, r = out["eager"], out["graph"]
    same = (all(bool(torch.equal(a, c)) for a, c in zip(e["state"], r["state"]))
            and bool(torch.equal(e["stats"].chi2_final, r["stats"].chi2_final))
            and bool(torch.equal(e["stats"].lambda_final, r["stats"].lambda_final))
            and e["stats"].iterations == r["stats"].iterations == SE3_CAPTURE_ITERS)
    print(f"SE3 LM at {n_nodes} nodes, {SE3_CAPTURE_ITERS} iterations eager / "
          f"replayed: chi2 {float(e['stats'].chi2_final)!r} / "
          f"{float(r['stats'].chi2_final)!r}, lambda {float(e['stats'].lambda_final)!r}"
          f" / {float(r['stats'].lambda_final)!r}, bitwise equal state, chi2 and "
          f"lambda {same}; {e['ms']:.3f} / {r['ms']:.3f} ms an iteration, a solve of "
          f"2 iterations {e['ms_2']:.1f} / {r['ms_2']:.1f} ms (the replayed one "
          f"captures), CUDA kernels an iteration {e['kernels']} / {r['kernels']}",
          flush=True)
    report["se3_capture"] = {
        "nodes": n_nodes, "iterations": SE3_CAPTURE_ITERS, "bitwise_equal": same,
        **{f"{k}_{name}": v[k] for name, v in out.items() for k in ("ms", "ms_2", "kernels")},
    }
    check(same, "the replayed SE3 LM iterations differ from the eager ones")
    check(r["kernels"] is not None, "the profiler saw no kernel of the replayed iterations")


# ---------------------------------------------------------------- hdl drive

def hdl_drive(cfg, frames, gts, warmup, imu=False, device="cuda", threaded=False,
              watch=None, trace=True, window=None, gps=True):
    """The hdl pipeline (``cfg``, a preset name or a PipelineConfig) as
    bench.py:221-267 drives it: ``warmup`` frames and two update steps, the
    timers reset, then the timed frames (GPS before every scan unless
    ``gps`` is off; with ``imu`` an identity orientation and gravity-only
    acceleration too) and finish(). Returns (pipeline, non-empty per-cycle
    stats, frames with floor coefficients (also ``pipe.floor_frames``),
    wall seconds of the timed frames to the last on_points return and to
    finish(), the odometry of every frame). ``watch(pipe)`` may wrap the
    pipeline's parts before the drive; ``trace`` and ``window`` as in
    city_drive."""
    from delta_graph_slam_tpu_torch.config import get_preset
    from delta_graph_slam_tpu_torch.pipeline.runner import Pipeline

    if isinstance(cfg, str):
        cfg = get_preset(cfg)
    pipe = Pipeline(cfg, device=device, threaded=threaded)
    cycles, odo = recorded(pipe) if trace else ([], [])
    if trace and not threaded:     # the trace reads the graph between update steps
        trace_drive(pipe)
    if watch is not None:
        watch(pipe)
    pipe.floor_frames, floor_cb = 0, pipe.backend.floor_coeffs_callback

    def counted_floor(stamp, coeffs):
        pipe.floor_frames += coeffs is not None
        return floor_cb(stamp, coeffs)

    pipe.backend.floor_coeffs_callback = counted_floor

    def feed(fr, gt):
        if gps:
            pipe.on_gps(fr.stamp, *fr.gps)
        if imu:     # level flight: tests/test_pipeline_e2e.py:186-191
            pipe.on_imu(fr.stamp, [1.0, 0.0, 0.0, 0.0],
                        linear_acceleration=[0.0, 0.0, 9.81])
        pipe.on_points(fr.stamp, fr.points, gt_pose=gt)

    wall, wall_finish = timed_drive(pipe, frames, gts, warmup, feed, window)
    return pipe, [c for c in cycles if c], pipe.floor_frames, wall, wall_finish, odo


def edge_counts(builder):
    """Edges of a graph builder by type."""
    out = {}
    for e in builder.edges:
        out[e["type"]] = out.get(e["type"], 0) + 1
    return out


def run_hdl(report, frames, gts, reference, device="cuda"):
    import tempfile

    import torch

    from delta_graph_slam_tpu_torch.graph import load_g2o_se3
    from delta_graph_slam_tpu_torch.io.pcd import load_pcd
    from delta_graph_slam_tpu_torch.ops import nn_kernel

    n_timed = len(frames) - CITY_WARMUP
    print(f"float32 matmul precision {torch.get_float32_matmul_precision()!r}, "
          f"torch.backends.cuda.matmul.allow_tf32 "
          f"{torch.backends.cuda.matmul.allow_tf32}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    nn_kernel.launches = 0
    pipe, cycles, n_floor, wall, wall_finish, odo_record = hdl_drive(
        "hdl_400", frames, gts, CITY_WARMUP, device=device)
    launches = nn_kernel.launches
    peak = torch.cuda.max_memory_allocated()
    be = pipe.backend
    m = pipe.evaluate()
    counts = edge_counts(be.graph)
    n_kf = len(be.keyframes)
    nodes = [k.node_id for k in be.keyframes]
    consecutive = {frozenset(p) for p in zip(nodes[1:], nodes[:-1])}
    odo = sum(1 for e in be.graph.edges if e["type"] == "se3"
              and frozenset((e["i"], e["j"])) in consecutive)
    loops = counts.get("se3", 0) - odo - (be.anchor_node is not None)
    t = pipe.timing_summary()

    def per_frame(k):
        return t[k]["total_s"] * 1000.0 / n_timed if k in t else float("nan")

    def per_call(k):
        return t[k]["mean_ms"] if k in t else float("nan")

    iters = [c["lm_iters"] for c in cycles]
    chi2 = [c["chi2"] for c in cycles]
    poses = np.stack(be.graph.poses)
    print(f"{n_timed} frames in {wall:.3f} s: {n_timed / wall:.3f} frames/s; keyframes "
          f"{n_kf}, frames with floor coefficients {n_floor} of {len(frames)}, edges "
          f"{counts} ({odo} odometry, {loops} loops), cycles {len(cycles)}, nn1 "
          f"launches {launches}, peak device memory {peak / 2**20:.1f} MiB", flush=True)
    print("ms per frame: prefiltering {:.3f}, odometry {:.3f}, floor_detection {:.3f}; "
          "ms per call: optimization_step {:.3f}, optimize {:.3f}, loop_detection "
          "{:.3f}".format(per_frame("prefiltering"), per_frame("odometry"),
                          per_frame("floor_detection"), per_call("optimization_step"),
                          per_call("backend.optimize"),
                          per_call("backend.loop_detection")), flush=True)
    print(f"LM iterations per cycle {iters}", flush=True)
    print(f"chi2 per cycle {chi2}", flush=True)
    print("ATE {ATE_mean:.4f} m (std {ATE_std:.4f}), t-RPE {t_RPE_mean:.4f} m, "
          "r-RPE {r_RPE_mean:.5f} rad".format(**m), flush=True)

    with tempfile.TemporaryDirectory() as d:
        saved = pipe.save_map(d)
        n_map = len(load_pcd(Path(d) / "map.pcd")) if (Path(d) / "map.pcd").exists() else 0
        dumped = be.dump_graph(d)
        back = load_g2o_se3(Path(d) / "graph.g2o", device="cpu")
    back_counts = (len(back.poses), len(back.planes), edge_counts(back))
    want_counts = (len(be.graph.poses), len(be.graph.planes),
                   {k: v for k, v in counts.items() if k in ("se3", "se3plane")})
    print(f"save_map: {saved}, map.pcd points {n_map}; dump_graph: {dumped}, "
          f"graph.g2o read back with (poses, planes, edges) {back_counts}", flush=True)

    # the same frames again: is the drive bit-repeatable?
    pipe_2, cycles_2, _, wall_2, _, _ = hdl_drive("hdl_400", frames, gts, CITY_WARMUP,
                                                  device=device)
    poses_2 = np.stack(pipe_2.backend.graph.poses)
    same = {
        "poses": poses.shape == poses_2.shape and bool(np.array_equal(poses, poses_2)),
        "chi2": chi2 == [c["chi2"] for c in cycles_2],
        "lm_iters": iters == [c["lm_iters"] for c in cycles_2],
    }
    gap = (float(np.abs(poses - poses_2).max()) if poses.shape == poses_2.shape
           else float("nan"))
    print(f"the hdl drive twice: bitwise equal {same}, largest pose gap {gap:.3e} "
          f"({n_timed / wall_2:.3f} frames/s the second time)", flush=True)
    misses = held_to_reference("hdl_400", pipe, reference, report)

    nn_kernel.launches = 0
    pipe_i, cycles_i, _, wall_i, _, _ = hdl_drive("hdl_imu", frames[:IMU_FRAMES],
                                                  gts[:IMU_FRAMES], 0, imu=True,
                                                  device=device)
    launches_i = nn_kernel.launches
    counts_i = edge_counts(pipe_i.backend.graph)
    n_kf_i = len(pipe_i.backend.keyframes)
    finite_i = bool(np.isfinite(pipe_i.backend.poses2d).all())
    print(f"hdl_imu, {IMU_FRAMES} frames: {IMU_FRAMES / wall_i:.3f} frames/s, "
          f"keyframes {n_kf_i}, edges {counts_i}, LM iterations per cycle "
          f"{[c['lm_iters'] for c in cycles_i]}, poses finite {finite_i}", flush=True)

    report["hdl"] = {
        "frames": n_timed, "warmup_frames": CITY_WARMUP, "wall_s": wall,
        "frames_per_s": n_timed / wall, "keyframes": n_kf, "floor_frames": n_floor,
        "edges": counts, "odometry_edges": odo, "loops": loops, "cycles": cycles,
        "nn1_launches": launches, "peak_mem_bytes": peak, "timing": t, "metrics": m,
        "map_points": n_map, "g2o_read_back": [back_counts[0], back_counts[1],
                                               back_counts[2]],
        "repeat_bitwise_equal": same, "repeat_max_pose_gap": gap,
        "repeat_frames_per_s": n_timed / wall_2,
        "imu": {"frames": IMU_FRAMES, "frames_per_s": IMU_FRAMES / wall_i,
                "keyframes": n_kf_i, "edges": counts_i, "cycles": cycles_i,
                "nn1_launches": launches_i},
    }
    check(n_floor >= 0.9 * len(frames),
          f"floor coefficients on {n_floor} of {len(frames)} frames, need 90 %")
    check(be.floor_plane_node is not None, "no floor-plane vertex")
    check(counts.get("se3plane", 0) >= n_kf,
          f"{counts.get('se3plane', 0)} se3plane edges for {n_kf} keyframes")
    check(odo == n_kf - 1, f"{odo} se3 odometry edges for {n_kf} keyframes")
    check(be.anchor_node is not None, "no anchor vertex")
    check(cycles and all(np.isfinite(c) for c in chi2), f"chi2 not finite: {chi2}")
    check(np.isfinite(poses).all(), "non-finite keyframe poses")
    check(m["ATE_mean"] <= 1.0, f"hdl ATE {m['ATE_mean']} m > 1.0 m")
    check(launches > 0, "the hdl drive launched no nn1 kernel")
    check(launches >= odo, f"nn1 launched {launches} times for {odo} odometry edges")
    check(saved and n_map > 0, f"save_map wrote {n_map} points")
    check(dumped and back_counts == want_counts,
          f"graph.g2o read back as {back_counts}, the graph holds {want_counts}")
    check(counts_i.get("quat", 0) >= n_kf_i - 1 and counts_i.get("vec", 0) >= n_kf_i - 1,
          f"hdl_imu: edges {counts_i} for {n_kf_i} keyframes")
    check(n_kf_i >= 3 and finite_i, f"hdl_imu: {n_kf_i} keyframes, finite {finite_i}")
    check(launches_i > 0, "the hdl_imu drive launched no nn1 kernel")
    misses += held_to_reference("hdl_imu", pipe_i, reference, report)
    check(not misses, f"the hdl_400 and hdl_imu drives against the reference: {misses}")
    return launches + launches_i, serial_record(pipe, wall, wall_finish, odo_record)


# ------------------------------------------------------- registration heads

def odometry_drive(frames, registration):
    """phase 4's drive with the odometry registration replaced; returns
    (odometry frames, pipeline, wall seconds)."""
    import torch

    from delta_graph_slam_tpu_torch.config import get_preset

    cfg = get_preset("delta")
    cfg = dataclasses.replace(cfg, odometry=dataclasses.replace(
        cfg.odometry, registration=registration))
    pipe = make_pipeline(cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    odo = drive(pipe, frames)
    pipe.finish()
    torch.cuda.synchronize()
    return odo, pipe, time.perf_counter() - t0


def odometry_quality(odo, gts):
    """(converged share, drift m, path m, GN iterations a frame)."""
    path = float(sum(np.linalg.norm(gts[k + 1][:2] - gts[k][:2])
                     for k in range(len(gts) - 1)))
    drift = float(np.linalg.norm(odo[-1].pose[:2, 3] - gts[-1][:2]))
    return (float(np.mean([f.converged for f in odo[1:]])), drift, path,
            float(np.mean([f.iterations for f in odo[1:]])))


def run_heads(report, frames, lap, reference):
    """Phase 11: the NDT and VGICP heads on phase 4's frames, then the
    nodelet-default NDT backend registration validating loops on phase 7's
    lap."""
    from delta_graph_slam_tpu_torch.config import get_preset
    from delta_graph_slam_tpu_torch.models.hdl_backend import HdlBackendConfig
    from delta_graph_slam_tpu_torch.ops import nn_kernel
    from delta_graph_slam_tpu_torch.register.config import REGISTRATION_PRESETS

    gts = rel_gt(frames)
    gicp = report["slice"]
    rows = {"FAST_GICP": {
        "odometry_ms_per_frame": gicp["ms_per_frame"]["odometry"],
        "gn_iterations_per_frame": float(np.mean(gicp["gn_iterations"])),
        "drift_m": gicp["drift_m"], "converged": gicp["converged_fraction"]}}
    print("FAST_GICP (phase 4): odometry {:.3f} ms/frame, GN iterations/frame {:.2f}, "
          "drift {:.4f} m".format(rows["FAST_GICP"]["odometry_ms_per_frame"],
                                  rows["FAST_GICP"]["gn_iterations_per_frame"],
                                  gicp["drift_m"]), flush=True)
    launches = 0
    heads = (("NDT_OMP", REGISTRATION_PRESETS["hdl"], False, "front_ndt_omp"),
             ("FAST_VGICP", dataclasses.replace(REGISTRATION_PRESETS["hdl"],
                                                method="FAST_VGICP"), True,
              "front_fast_vgicp"))
    misses = []
    for name, reg, hold_drift, ref_name in heads:
        nn_kernel.launches = 0
        odo, pipe, wall = odometry_drive(frames, reg)
        launches += nn_kernel.launches
        odo_2, _, _ = odometry_drive(frames, reg)
        same = all(np.array_equal(a.pose, b.pose) for a, b in zip(odo, odo_2))
        conv, drift, path, iters = odometry_quality(odo, gts)
        t = pipe.timing_summary()
        row = {"odometry_ms_per_frame": t["odometry"]["total_s"] * 1000.0 / len(frames),
               "gn_iterations_per_frame": iters, "converged": conv, "drift_m": drift,
               "path_m": path, "repeatable": same, "frames_per_s": len(frames) / wall}
        rows[name] = row
        print(f"{name}: odometry {row['odometry_ms_per_frame']:.3f} ms/frame, GN "
              f"iterations/frame {iters:.2f}, converged {conv:.3f}, drift {drift:.4f} m "
              f"over {path:.3f} m ({100 * drift / path:.2f}%"
              f"{'' if hold_drift else ', not held'}), two runs bitwise equal {same}",
              flush=True)
        check(conv >= 0.9, f"{name}: only {conv:.3f} of frames converged")
        check(same, f"{name}: two runs of the same frames differ")
        if hold_drift:
            check(drift <= 0.05 * path, f"{name}: drift {drift:.3f} m > 5% of {path:.3f} m")
        misses += held_to_reference(ref_name, front_arrays(odo), reference, report)

    # hdl_400 with the nodelet's NDT_OMP backend registration over the lap
    cfg = get_preset("hdl_400")
    cfg = dataclasses.replace(cfg, hdl=dataclasses.replace(
        cfg.hdl, registration=HdlBackendConfig().registration))
    lap_gts = rel_gt(lap)
    nn_kernel.launches = 0
    aligned = []

    def watch(pipe):
        reg = pipe.backend.loop_detector.registration
        align = reg._align

        def counted(*a):
            res = align(*a)
            aligned.append(bool(res.converged))
            return res

        reg._align = counted

    pipe, cycles, _, wall, _, _ = hdl_drive(cfg, lap, lap_gts, 0, watch=watch)
    launches += nn_kernel.launches
    loops = [c.get("loops", 0) for c in cycles]
    m = pipe.evaluate()
    print(f"hdl_400 + NDT_OMP backend registration, {len(lap)}-frame lap: "
          f"{len(lap) / wall:.3f} frames/s, keyframes {len(pipe.backend.keyframes)}, "
          f"loop candidates aligned through NDT {len(aligned)} ({sum(aligned)} "
          f"converged), loops accepted {sum(loops)}, ATE {m['ATE_mean']:.4f} m", flush=True)
    rows["hdl_ndt_lap"] = {"candidates_aligned": len(aligned),
                           "candidates_converged": sum(aligned), "loops": sum(loops),
                           "keyframes": len(pipe.backend.keyframes), "metrics": m,
                           "frames_per_s": len(lap) / wall}
    report["heads"] = rows
    check(len(aligned) >= 1, "no loop candidate was aligned through NDT")
    check(all(np.isfinite(c["chi2"]) for c in cycles), "hdl NDT lap: chi2 not finite")
    misses += held_to_reference("lap_ndt_loops", pipe, reference, report)
    check(not misses, f"the registration heads against the reference: {misses}")
    return launches


# ---------------------------------------------------------- threaded runner

def lock_waits(timing):
    return {k: v["total_s"] for k, v in timing.items() if "lock_wait" in k}


def odometry_gap(a, b):
    """(largest pose-entry gap, first frame that differs or -1) of two
    odometry records."""
    if len(a) != len(b):
        return float("nan"), -1
    d = np.abs(np.stack([np.frombuffer(x) for x in a])
               - np.stack([np.frombuffer(x) for x in b])).max(1)
    return float(d.max()), int(np.argmax(d > 0)) if (d > 0).any() else -1


def held_against_serial(name, pipe, wall, wall_finish, odo, serial, n_timed):
    """Phase 12's checks and prints of one threaded drive against the serial
    drive of the same frames (phase 8's or phase 10's first drive)."""
    t = pipe.timing_summary()
    stamps = [k.stamp for k in pipe.backend.keyframes]
    same = {"keyframe_stamps": stamps == serial["stamps"], "odometry": odo == serial["odo"]}
    m = pipe.evaluate()
    st = serial["timing"]

    def opt(timing):
        o = timing.get("optimization_step", {"mean_ms": float("nan"), "count": 0})
        return o["mean_ms"], o["count"]

    row = {
        "frames_per_s_to_last_on_points": n_timed / wall,
        "frames_per_s_to_finish": n_timed / wall_finish,
        "serial_frames_per_s_to_last_on_points": n_timed / serial["wall"],
        "serial_frames_per_s_to_finish": n_timed / serial["wall_finish"],
        "optimization_step_ms": opt(t)[0], "optimization_step_calls": opt(t)[1],
        "serial_optimization_step_ms": opt(st)[0],
        "serial_optimization_step_calls": opt(st)[1],
        "lock_wait_s": lock_waits(t), "serial_lock_wait_s": lock_waits(st),
        "keyframes": len(stamps), "bitwise_equal_to_serial": same, "metrics": m,
        "timing": t, "odometry_gap_to_serial": odometry_gap(odo, serial["odo"]),
    }
    print(f"{name} threaded: {row['frames_per_s_to_last_on_points']:.3f} frames/s to the "
          f"last on_points, {row['frames_per_s_to_finish']:.3f} to finish() (serial "
          f"{row['serial_frames_per_s_to_last_on_points']:.3f} / "
          f"{row['serial_frames_per_s_to_finish']:.3f}); optimization_step "
          f"{row['optimization_step_ms']:.1f} ms x {row['optimization_step_calls']} "
          f"(serial {row['serial_optimization_step_ms']:.1f} ms x "
          f"{row['serial_optimization_step_calls']}); lock_wait {row['lock_wait_s']} "
          f"(serial {row['serial_lock_wait_s']}); keyframes {len(stamps)}, bitwise equal "
          f"to serial {same}, odometry gap (max, first frame) "
          f"{row['odometry_gap_to_serial']}; ATE {m['ATE_mean']:.4f} m (serial "
          f"{serial['ate']:.4f})", flush=True)
    print(f"{name} threaded, ms per call: " + ", ".join(
        f"{k} {v['mean_ms']:.2f} x {v['count']}" for k, v in sorted(t.items())), flush=True)
    check(all(same.values()), f"{name}: threaded drive differs from serial: {same}")
    check(m["ATE_mean"] <= 1.0, f"{name} threaded: ATE {m['ATE_mean']} m > 1.0 m")
    return row


def run_threaded(report, world, frames, gts, serial_city, serial_hdl):
    """Phase 12: the building drive and the hdl_400 drive through
    Pipeline(threaded=True), held against phase 8's and phase 10's first
    (serial) drives."""
    from delta_graph_slam_tpu_torch.ops import nn_kernel

    n_timed = len(frames) - CITY_WARMUP
    nn_kernel.launches = 0
    try:
        pipe, _, wall, wall_finish, odo = city_drive(world, frames, gts, threaded=True)
    except Exception as e:  # noqa: BLE001 - reported as the phase's failure
        fail(f"threaded building drive: {e!r}")
    rows = {"buildings": held_against_serial("building drive", pipe, wall, wall_finish,
                                             odo, serial_city, n_timed)}
    try:
        pipe, _, _, wall, wall_finish, odo = hdl_drive("hdl_400", frames, gts, CITY_WARMUP,
                                                       threaded=True)
    except Exception as e:  # noqa: BLE001 - reported as the phase's failure
        fail(f"threaded hdl drive: {e!r}")
    rows["hdl"] = held_against_serial("hdl_400 drive", pipe, wall, wall_finish, odo,
                                      serial_hdl, n_timed)
    launches = nn_kernel.launches
    rows["nn1_launches"] = launches
    report["threaded"] = rows
    check(launches > 0, "the threaded drives launched no nn1 kernel")
    return launches


# ------------------------------------------- phase 13: the host runtime

CLI_FRAMES = 120          # phase 8's frames recorded to a bag for the CLI run
RESUME_AT = CITY_WARMUP + 120   # frames driven before the checkpoint
KITTI_FILES = 8
DENSE_RADIUS = 0.8
DENSE_CHUNK = 4096


def pcio_check(report, frames, work):
    """The native host I/O library built from the port's source: its path,
    a 131072-point PCD round trip, KITTI .bin files and a scan spool of
    phase 4's frames, all bitwise."""
    from delta_graph_slam_tpu_torch import native
    from delta_graph_slam_tpu_torch.io.lidar_sim import save_kitti_bin
    from delta_graph_slam_tpu_torch.io.pcd import load_pcd

    t0 = time.perf_counter()
    lib = native.load_library(build=True)
    build_s = time.perf_counter() - t0
    root = Path(__file__).resolve().parent
    path = Path(lib._name) if lib is not None else None
    check(path is not None and path == native.library_path()
          and path.parent == root / "delta_graph_slam_tpu_torch" / "_build",
          f"libpcio not loaded from the port's _build/: {path}")
    print(f"libpcio: {path.relative_to(root)} (built and loaded in {build_s:.2f} s)",
          flush=True)
    pts = np.random.default_rng(13).uniform(-80, 80, (131072, 3)).astype(np.float32)
    native.save_pcd(work / "cloud.pcd", pts)
    back = native.load_pcd(work / "cloud.pcd")
    check(np.array_equal(back, pts) and np.array_equal(load_pcd(work / "cloud.pcd"), pts),
          "the 131072-point PCD round trip differs")
    bins = []
    for k, fr in enumerate(frames):
        bins.append(work / "velodyne" / f"{k:010d}.bin")
        bins[-1].parent.mkdir(exist_ok=True)
        save_kitti_bin(bins[-1], fr.points)
    check(all(np.array_equal(native.load_kitti_bin(b), fr.points)
              for b, fr in zip(bins, frames)), "KITTI .bin read back differs")
    t0 = time.perf_counter()
    w = native.ScanSpool(str(work / "scans.spool"), "w")
    for fr in frames:
        w.append(fr.stamp, fr.points)
    w.close()
    write_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    t0 = time.perf_counter()
    r = native.ScanSpool(str(work / "scans.spool"))
    got = [(r.stamp(i), r.read(i)) for i in range(len(r))]
    r.close()
    read_ms = (time.perf_counter() - t0) * 1e3 / len(frames)
    check(len(got) == len(frames) and all(
        s == fr.stamp and np.array_equal(p, fr.points) for (s, p), fr in zip(got, frames)),
        "the scan spool read back differs")
    print(f"PCD 131072 points bitwise; {len(frames)} KITTI .bin files bitwise; spool "
          f"write {write_ms:.3f} ms/frame, read {read_ms:.3f} ms/frame "
          f"({np.mean([len(f.points) for f in frames]):.0f} points a frame)", flush=True)
    report["pcio"] = {"library": str(path.relative_to(root)), "build_s": build_s,
                      "spool_write_ms_per_frame": write_ms,
                      "spool_read_ms_per_frame": read_ms}
    return bins


def record_drive(world, frames, work):
    """The first CLI_FRAMES frames of phase 8's drive as a bag (points and
    gps topics; each GPS stamp 1 ms before its scan: Bag.from_npz gathers
    topics as a set, so equal stamps of two topics would reorder with the
    interpreter's hash seed) and the city's OSM XML as a file."""
    from delta_graph_slam_tpu_torch.io.bag import Bag, Message

    msgs = []
    for fr in frames[:CLI_FRAMES]:
        msgs.append(Message(fr.stamp - 1e-3, "gps", np.asarray(fr.gps, float)))
        msgs.append(Message(fr.stamp, "points", fr.points))
    Bag(msgs).save_npz(work / "drive.npz")
    (work / "city.osm").write_text(world.osm_xml())
    return work / "drive.npz", work / "city.osm"


def cli_drive(report, world, frames, bins, work, device="cuda"):
    """``cli run`` on the recorded drive, held bitwise to a Pipeline drive of
    the same messages; then ``convert-kitti`` on KITTI_FILES .bin files."""
    import contextlib
    import io
    import shutil

    import torch

    from delta_graph_slam_tpu_torch import cli
    from delta_graph_slam_tpu_torch.buildings import StaticProvider
    from delta_graph_slam_tpu_torch.config import get_preset
    from delta_graph_slam_tpu_torch.io.bag import Bag
    from delta_graph_slam_tpu_torch.ops import nn_kernel
    from delta_graph_slam_tpu_torch.pipeline.runner import Pipeline

    bag, osm = record_drive(world, frames, work)
    out = work / "cli_out"
    torch.cuda.synchronize()
    nn_kernel.launches = 0
    captured = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(captured):
        rc = cli.main(["run", "--preset", "delta", "--bag", str(bag), "--osm-file", str(osm),
                       "--save-map", str(out), "--dump-graph", str(out),
                       "--save-viz", str(out), "--eval"]
                      + ([] if device == "cuda" else ["--device", device]))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = nn_kernel.launches
    text = captured.getvalue()
    check(rc == 0, f"cli run returned {rc}: {text[-2000:]}")
    summary, _ = json.JSONDecoder().raw_decode(text)
    files = {n: (out / n).stat().st_size if (out / n).exists() else 0
             for n in ("map.pcd", "b_map.pcd", "aligned_b_map.pcd", "graph.g2o",
                       "graph.npz", "markers.json", "markers.svg")}

    pipe = Pipeline(get_preset("delta"), building_provider=StaticProvider(osm.read_text()),
                    device=device)
    t0 = time.perf_counter()
    for m in Bag.from_npz(bag):
        if m.topic == "gps":
            pipe.on_gps(m.stamp, *np.asarray(m.data).tolist())
        else:
            pipe.on_points(m.stamp, np.asarray(m.data))
    pipe.finish()
    torch.cuda.synchronize()
    wall_direct = time.perf_counter() - t0
    g = np.load(out / "graph.npz")
    direct = pipe.backend.poses
    same = (summary["keyframes"] == len(pipe.backend.keyframes)
            and int(g["vmask"].sum()) == len(direct)
            and np.array_equal(g["poses"][: len(direct)], direct))
    timing = summary["timing"]
    print(f"cli run: {CLI_FRAMES} frames in {wall:.3f} s of cli.main (exports included): "
          f"{CLI_FRAMES / wall:.3f} frames/s; the direct Pipeline drive "
          f"{CLI_FRAMES / wall_direct:.3f} frames/s; keyframes {summary['keyframes']}, "
          f"final poses bitwise equal to the direct drive {same}; nn1 launches {launches}",
          flush=True)
    print("cli timing summary (mean ms): " + ", ".join(
        f"{k} {v['mean_ms']:.3f} x{v['count']}" for k, v in timing.items()), flush=True)
    print(f"cli files (bytes): {files}", flush=True)
    check(all(files.values()), f"cli run wrote {files}")
    check(same, "the cli run's keyframes or poses differ from the direct Pipeline drive")
    check(launches > 0, "the cli run launched no nn1 kernel")

    kitti = work / "kitti"
    kitti.mkdir()
    for b in bins:
        shutil.copy(b, kitti / b.name)
    rc = cli.main(["convert-kitti", "--velodyne-dir", str(kitti),
                   "--out", str(work / "kitti.npz")])
    conv = Bag.from_npz(work / "kitti.npz")
    held = (rc == 0 and len(conv) == len(bins) and all(
        np.array_equal(np.asarray(m.data), np.fromfile(b, np.float32).reshape(-1, 4)[:, :3])
        for m, b in zip(conv, bins)))
    print(f"convert-kitti: {len(conv)} scans, bitwise the .bin files {held}", flush=True)
    check(held, "convert-kitti's bag differs from the .bin files")
    report["cli"] = {"frames": CLI_FRAMES, "wall_s": wall, "frames_per_s": CLI_FRAMES / wall,
                     "direct_frames_per_s": CLI_FRAMES / wall_direct,
                     "keyframes": summary["keyframes"], "bitwise_equal_direct": same,
                     "nn1_launches": launches, "timing": timing, "files": files,
                     "metrics": json.JSONDecoder().raw_decode(
                         text[text.index('{\n  "metrics"'):])[0]["metrics"]}
    return launches


def checkpoint_drive(report, world, frames, gts, work, reference, device="cuda"):
    """Phase 8's drive cut at RESUME_AT: save_state, a fresh Pipeline on the
    card, load_state, the remaining frames with a 10 Hz Map2OdomPublisher;
    both halves held to the reference's drive of the same calls."""
    import torch

    from delta_graph_slam_tpu_torch.buildings import StaticProvider
    from delta_graph_slam_tpu_torch.config import get_preset
    from delta_graph_slam_tpu_torch.geom.host import transform_2d_to_3d_np
    from delta_graph_slam_tpu_torch.io.tf_table import TransformTable
    from delta_graph_slam_tpu_torch.ops import nn_kernel
    from delta_graph_slam_tpu_torch.pipeline.map2odom import Map2OdomPublisher
    from delta_graph_slam_tpu_torch.pipeline.runner import Pipeline

    cfg = get_preset("delta")
    launches = nn_kernel.launches
    pipe = Pipeline(cfg, building_provider=StaticProvider(world.osm_xml()), device=device)
    trace_drive(pipe)
    drive(pipe, frames[:RESUME_AT], gts[:RESUME_AT])
    pipe.finish()
    path = work / "state.npz"
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe.save_state(path)
    save_ms = (time.perf_counter() - t0) * 1e3
    size_mb = sum(p.stat().st_size for p in work.glob("state.npz*")) / 2**20

    resumed = Pipeline(cfg, building_provider=StaticProvider(world.osm_xml()), device=device)
    t0 = time.perf_counter()
    cap = cfg.prefiltering.out_capacity
    resumed.load_state(path, cloud_capacity=cap, flat_capacity=cap)
    torch.cuda.synchronize()
    load_ms = (time.perf_counter() - t0) * 1e3
    b1, b2 = pipe.backend, resumed.backend
    gap = float(np.abs(b2.poses - b1.poses).max())
    print(f"checkpoint after {RESUME_AT} frames: {len(b1.keyframes)} keyframes, "
          f"{len(b1.buildings_manager.buildings)} buildings; save {save_ms:.1f} ms, "
          f"load {load_ms:.1f} ms, {size_mb:.2f} MB; poses after the load within "
          f"{gap:.3g} m of the saved pipeline's (limit 1e-6)", flush=True)
    check(len(b2.keyframes) == len(b1.keyframes) and gap <= 1e-6,
          f"the loaded state differs: {len(b2.keyframes)} keyframes, pose gap {gap}")

    trace_resumed(resumed, pipe.drive_trace)
    table = TransformTable()
    pub = Map2OdomPublisher(table, b2, rate_hz=10.0).start()
    try:
        drive(resumed, frames[RESUME_AT:], gts[RESUME_AT:])
        resumed.finish()
    finally:
        pub.stop()
    check(not pub._thread.is_alive(), "the map2odom thread did not stop")
    pub.publish_once()
    lifted = transform_2d_to_3d_np(b2.trans_odom2map)
    check(np.array_equal(table.lookup("map", "odom"), lifted),
          "map->odom differs from the lifted trans_odom2map")
    m = resumed.evaluate()
    ate = report["buildings"]["metrics"]["ATE_mean"]
    misses = held_to_reference("city_resumed", resumed, reference, report)
    ate_ref = float(reference["city_resumed"]["metrics"][0])
    print(f"resumed drive: {len(b2.keyframes)} keyframes, ATE {m['ATE_mean']:.4f} m against "
          f"the uninterrupted drive's {ate:.4f} m (phase 8; difference "
          f"{m['ATE_mean'] - ate:+.4f} m); the reference's resumed drive {ate_ref:.6f} m "
          f"(gap {m['ATE_mean'] - ate_ref:+.6f} m, limit {REF_ATE_M}); map->odom equal "
          f"to the lifted trans_odom2map", flush=True)
    report["checkpoint"] = {"resume_at": RESUME_AT, "save_ms": save_ms, "load_ms": load_ms,
                            "state_mb": size_mb, "pose_gap_m": gap,
                            "keyframes_saved": len(b1.keyframes),
                            "keyframes_final": len(b2.keyframes), "metrics": m,
                            "uninterrupted_ate_m": ate}
    check(m["ATE_mean"] <= 1.0, f"resumed ATE {m['ATE_mean']} m > 1.0 m")
    check(not misses, f"the resumed drive against the reference: {misses}")
    return nn_kernel.launches - launches


def chunk_centres(cloud, chunk):
    """(N,3) float64: per query, the centre radius_moments centres its chunk
    on (the masked centroid of its Morton-ordered chunk of queries)."""
    import torch

    from delta_graph_slam_tpu_torch.ops.moments import morton_keys

    pts, mask = cloud.points.double().numpy(), cloud.mask.numpy()
    order = torch.argsort(morton_keys(cloud.points, cloud.mask), stable=True).numpy()
    centre = np.zeros_like(pts)
    for c0 in range(0, len(pts), chunk):
        idx = order[c0:c0 + chunk]
        if mask[idx].any():
            centre[idx] = pts[idx][mask[idx]].mean(0)
    return centre


def boundary_queries(pts, mask, centre, r2, block=1024, device="cuda"):
    """Valid queries with a valid support point (the cloud itself) whose
    squared distance (float64 on ``device``) lies within the float32
    rounding of radius_moments' expansion |qc|^2 + |xc|^2 - 2 xc.qc about
    the query's chunk centre: 1e-5 of r2 plus 1e-6 of |qc|^2 + |xc|^2 (the
    expansion's error is a few float32 ulps of those terms)."""
    import torch

    p = torch.from_numpy(pts).to(device).double()
    c = torch.from_numpy(centre).to(device)
    m = torch.from_numpy(mask).to(device)
    out = torch.zeros(len(pts), dtype=torch.bool, device=device)
    for c0 in range(0, len(pts), block):
        q, cq = p[c0:c0 + block], c[c0:c0 + block]
        d2 = ((q[:, None, :] - p[None, :, :]) ** 2).sum(-1)
        terms = (((q - cq) ** 2).sum(-1)[:, None]
                 + ((p[None, :, :] - cq[:, None, :]) ** 2).sum(-1))
        out[c0:c0 + block] = (((d2 - r2).abs() <= 1e-5 * r2 + 1e-6 * terms)
                              & m[None, :]).any(1)
    return (out & m).cpu().numpy()


def dense_check(report, frames, reference, device="cuda"):
    """radius_moments on the card against the port's plain CPU run at the
    front end's shape, then phase 4's frames with the 'dense' methods."""
    import torch

    from delta_graph_slam_tpu_torch.config import get_preset
    from delta_graph_slam_tpu_torch.models.prefiltering import PrefilteringStage
    from delta_graph_slam_tpu_torch.ops import nn_kernel
    from delta_graph_slam_tpu_torch.ops.cloud import MaskedCloud
    from delta_graph_slam_tpu_torch.ops.moments import radius_moments

    cfg = get_preset("delta")
    scan = PrefilteringStage(cfg.prefiltering, device=device).process(frames[0].points)
    cloud = scan.filtered3d
    pts, mask = cloud.points.cpu().numpy(), cloud.mask.cpu().numpy()

    def card():
        return radius_moments(cloud, cloud, DENSE_RADIUS, chunk=DENSE_CHUNK)

    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    got = card()
    torch.cuda.synchronize()
    peak_mb = (torch.cuda.max_memory_allocated() - base) / 2**20
    ms = cuda_ms(card, reps=10, warmup=2)
    t0 = time.perf_counter()
    cpu_cloud = MaskedCloud(torch.from_numpy(pts), torch.from_numpy(mask))
    want = radius_moments(cpu_cloud, cpu_cloud, DENSE_RADIUS, chunk=DENSE_CHUNK)
    cpu_s = time.perf_counter() - t0
    r2 = float(np.float32(DENSE_RADIUS) ** 2)
    centre = chunk_centres(cpu_cloud, DENSE_CHUNK)
    edge = boundary_queries(pts, mask, centre, r2, device=device)
    cnt_g, cnt_w = got.count.cpu().numpy(), want.count.numpy()
    held = mask & ~edge
    count_diff = int((cnt_g != cnt_w)[held].sum())
    v = held & (cnt_w >= 1)
    # float32 rounds the raw moments about the chunk centre, so both runs
    # carry an error that scales with the neighbourhood's second moment
    # about it (s2, up to ~3,500 m^2 at a scan's extent; float32 against
    # float64 on the CPU: 6.8e-7 of s2): held within 1e-5 of max(1, s2)
    s2 = (((want.mean.double().numpy() - centre) ** 2).sum(1)
          + np.trace(want.cov.double().numpy(), axis1=1, axis2=2))
    mean_d = np.abs(got.mean.cpu().numpy() - want.mean.numpy()).max(1)
    cov_d = np.abs(got.cov.cpu().numpy() - want.cov.numpy()).max((1, 2))
    mean_rel = float((mean_d / np.sqrt(np.maximum(s2, 1.0)))[v].max())
    cov_rel = float((cov_d / np.maximum(s2, 1.0))[v].max())
    print(f"radius_moments {int(mask.sum())} x {int(mask.sum())} valid of {len(pts)}^2 slots, "
          f"r {DENSE_RADIUS} m, chunk {DENSE_CHUNK}: card {ms:.3f} ms (median of 10, CUDA "
          f"events), peak {peak_mb:.0f} MiB above the inputs; plain CPU run {cpu_s:.2f} s; "
          f"{int(edge.sum())} queries with a pair within float32 rounding of r^2 left "
          f"out; count "
          f"differences {count_diff}; mean error {mean_d[v].max():.3g} m ({mean_rel:.3g} of "
          f"max(1, sqrt(s2)), limit 1e-5), cov error {cov_d[v].max():.3g} ({cov_rel:.3g} of "
          f"max(1, s2), limit 1e-5); mean count {cnt_w[mask].mean():.1f}", flush=True)
    row = {"cuda_ms": ms, "peak_mib": peak_mb, "cpu_s": cpu_s,
           "boundary_queries": int(edge.sum()), "count_differences": count_diff,
           "mean_err_m": float(mean_d[v].max()), "mean_err_rel": mean_rel,
           "cov_err": float(cov_d[v].max()), "cov_err_rel": cov_rel,
           "valid": int(mask.sum()), "mean_count": float(cnt_w[mask].mean())}
    report["dense"] = row
    check(count_diff == 0, f"{count_diff} counts differ between the card and the CPU")
    check(mean_rel <= 1e-5, f"radius_moments means differ by {mean_rel} of sqrt(s2)")
    check(cov_rel <= 1e-5, f"radius_moments covariances differ by {cov_rel} of s2")

    dense_cfg = dataclasses.replace(
        cfg, prefiltering=dataclasses.replace(cfg.prefiltering, neighbor_method="dense"),
        odometry=dataclasses.replace(cfg.odometry, registration=dataclasses.replace(
            cfg.odometry.registration, cov_method="dense")))
    launches = nn_kernel.launches
    runs = []
    for _ in range(2):
        pipe = make_pipeline(dense_cfg, device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        odo = drive(pipe, frames)
        pipe.finish()
        torch.cuda.synchronize()
        runs.append((odo, pipe, time.perf_counter() - t0))
    (odo, pipe, wall), (odo_2, _, wall_2) = runs
    same = all(np.array_equal(a.pose, b.pose) for a, b in zip(odo, odo_2))
    converged, drift, path, iters = odometry_quality(odo, rel_gt(frames))
    per_frame = {k: v["total_s"] * 1e3 / len(frames)
                 for k, v in pipe.timing_summary().items()}
    voxel = report["slice"]
    print(f"dense front end, {len(frames)} frames: {len(frames) / wall:.3f} frames/s "
          f"(again {len(frames) / wall_2:.3f}) against the voxel drive's "
          f"{voxel['frames_per_s']:.3f} (phase 4); ms/frame " + ", ".join(
              f"{k} {per_frame.get(k, 0.0):.3f} "
              f"(voxel {voxel['ms_per_frame'].get(k, 0.0):.3f})"
              for k in ("prefiltering", "odometry", "backend_enqueue", "optimization_step")),
          flush=True)
    print(f"dense front end: converged {converged:.3f}, drift {drift:.4f} m over "
          f"{path:.3f} m ({100 * drift / path:.3f}%), GN iterations/frame {iters:.2f}, "
          f"odometry bitwise equal across the two runs {same}", flush=True)
    row.update(frames_per_s=len(frames) / wall, repeat_frames_per_s=len(frames) / wall_2,
               ms_per_frame=per_frame, converged=converged, drift_m=drift, path_m=path,
               gn_iterations=iters, repeatable=same)
    check(converged >= 0.9, f"dense front end: only {converged:.3f} of frames converged")
    check(drift <= 0.05 * path, f"dense front end: drift {drift:.3f} m > 5% of {path:.3f} m")
    check(same, "the dense front end's odometry differs between two runs")
    misses = held_to_reference("front_dense", front_arrays(odo), reference, report)
    check(not misses, f"the dense front end against the reference: {misses}")
    return nn_kernel.launches - launches


def run_host_runtime(report, slice_frames, world, city, city_gts, reference,
                     device="cuda"):
    """Phase 13: libpcio, the command line on a recorded drive, a checkpoint
    in the middle of the building drive, and the 'dense' methods."""
    import tempfile

    with tempfile.TemporaryDirectory() as d:
        work = Path(d)
        bins = pcio_check(report, slice_frames, work)
        launches = cli_drive(report, world, city, bins[:KITTI_FILES], work, device)
        launches += checkpoint_drive(report, world, city, city_gts, work, reference,
                                     device)
    launches += dense_check(report, slice_frames, reference, device)
    return launches


# ------------------------------------------------------ phase 14: parallel/

def host_step(builder, lam):
    """The first LM step of the builder's se2 graph in float64 on the host:
    (H + lam I) dx = -J^T W r over every vertex but the fixed vertex 0,
    robust weights as host_lm's, scipy SuperLU. Returns dx (V,3)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl

    es = [e for e in builder.edges if e["type"] == "se2"]
    ei = np.asarray([e["i"] for e in es])
    ej = np.asarray([e["j"] for e in es])
    meas = np.asarray([e["meas"] for e in es], np.float64)
    infos = np.asarray([e["info"] for e in es], np.float64)
    huber = np.asarray([e["kernel"] == 1 for e in es])
    delta = np.asarray([e["delta"] for e in es], np.float64)
    x = np.asarray(builder.poses, np.float64)
    V = len(x)
    r, Ji, Jj = _host_linearize(x, ei, ej, meas)
    _, w = _host_robust(r, infos, huber, delta)
    Wf = infos * w[:, None, None]
    a3 = np.arange(3)
    rows, cols, vals = [], [], []
    for (Ja, va), (Jb, vb) in (((Ji, ei), (Ji, ei)), ((Ji, ei), (Jj, ej)),
                               ((Jj, ej), (Ji, ei)), ((Jj, ej), (Jj, ej))):
        blk = np.einsum("eba,ebc,ecd->ead", Ja, Wf, Jb)
        rows.append(np.broadcast_to(3 * va[:, None, None] + a3[None, :, None], blk.shape).ravel())
        cols.append(np.broadcast_to(3 * vb[:, None, None] + a3[None, None, :], blk.shape).ravel())
        vals.append(blk.ravel())
    H = sp.coo_matrix((np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
                      shape=(3 * V, 3 * V)).tocsc()
    g = np.zeros(3 * V)
    Wr = np.einsum("eab,eb->ea", Wf, r)
    np.add.at(g, (3 * ei[:, None] + a3).ravel(), np.einsum("eba,eb->ea", Ji, Wr).ravel())
    np.add.at(g, (3 * ej[:, None] + a3).ravel(), np.einsum("eba,eb->ea", Jj, Wr).ravel())
    H = H[3:, 3:] + sp.identity(3 * V - 3, format="csc") * lam
    dx = np.zeros(3 * V)
    dx[3:] = spl.splu(H).solve(-g[3:])
    return dx.reshape(V, 3)


def spike_step_errors(g, builder, Lc, device="cuda"):
    """One LM step of each layout on the card against host_step: the
    linear system at the initial poses, damped by the LM's first lambda
    (tau x the largest diagonal entry), solved by the whole-chain BCR, the
    SPIKE core solve (16 segments) and the locality-aware SPIKE solve (16
    segments, Lc slots). Returns ({layout: relative error}, dropped,
    lambda)."""
    import torch

    from delta_graph_slam_tpu_torch.graph import chain_lm
    from delta_graph_slam_tpu_torch.graph.chain_solve import chain_core_solve, finish_tridiag
    from delta_graph_slam_tpu_torch.graph.solver import _free_mask, _graph_f64
    from delta_graph_slam_tpu_torch.parallel import spike

    graph = _graph_f64(g)
    V = graph.poses.shape[0]
    free = _free_mask(graph, 0)
    cr, tail, chi2 = chain_lm._residual_pass(graph, graph.poses, 0, V - 1)
    bundle, t_off = chain_lm._assemble_bundle(graph, cr, tail, chi2, V - 1, V,
                                              (free > 0).any(dim=1))
    K = int(t_off.sum())
    order = torch.argsort((~t_off).to(torch.int32), stable=True)[:K]
    off = (tail.i[order], tail.j[order], tail.Ji[order], tail.Jj[order], tail.W[order])
    lam = 1e-5 * float(torch.diagonal(bundle.A0, dim1=-2, dim2=-1).abs().max())
    A, B = finish_tridiag(bundle.A0, bundle.B0, free,
                          torch.tensor(lam, dtype=torch.float64, device=device))
    local, dropped = spike.spike_local_solve(A, B, -bundle.b, free, V, 16, off, Lc)
    steps = {"whole": chain_core_solve(A, B, -bundle.b, free, V, off=off),
             "core16": spike.spike_core_solve(A, B, -bundle.b, free, V, 16, off=off),
             "auto": local}
    want = host_step(builder, lam)
    scale = np.abs(want).max()
    return ({k: float(np.abs(v.cpu().numpy() - want).max() / scale)
             for k, v in steps.items()}, int(dropped), lam)


@contextlib.contextmanager
def counted_calls(module, names):
    """Count the calls of ``module``'s functions ``names`` in the block
    (which solves a layout took); yields {name: calls}."""
    calls = {n: 0 for n in names}
    real = {n: getattr(module, n) for n in names}

    def wrap(n):
        def f(*a, **kw):
            calls[n] += 1
            return real[n](*a, **kw)
        return f

    for n in names:
        setattr(module, n, wrap(n))
    try:
        yield calls
    finally:
        for n in names:
            setattr(module, n, real[n])


def spike_graph(n_nodes):
    """(init, edges, gt, iterations): phase 6's cold start below 16384
    nodes; bench_multichip.py:123's warm start (ground truth plus the
    drift of one 3 s cycle) at 16384."""
    init, edges, gt = bench_graph(n_nodes)
    if n_nodes < SPIKE_WARM_NODES:
        return init, edges, gt, 30
    rng = np.random.default_rng(7)
    return gt + rng.normal(0, [0.05, 0.05, 0.005], gt.shape), edges, gt, SPIKE_WARM_ITERS


def spike_layouts(report, n_nodes, device="cuda", caps=None, profile=True):
    """Phase 14's graph half at one size: the three layouts of the SE2
    solve, each twice, timed, and one step of each against the host."""
    import torch

    from delta_graph_slam_tpu_torch.graph import SolverConfig, chain_lm, optimize_se2

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    t_start = time.perf_counter()
    init, edges, gt, iters = spike_graph(n_nodes)
    b = graph_builder(init, edges, device)
    g = b.to_arrays(chain_first=True)
    V = g.poses.shape[0]
    hint, need = b.count_offchain(0), b.spike_local_need(V, 0)
    Lc = 8
    while Lc < need:
        Lc *= 2
    base = SolverConfig(backend="chain", max_iterations=iters)
    layouts = {
        "whole": (base, {}),
        "core16": (dataclasses.replace(base, chain_segments=16), {}),
        "auto": (base, {"local_hint": need}),
    }
    out = {"nodes": n_nodes, "offchain": hint, "local_need": need, "Lc": Lc,
           "iterations_cap": iters, "layouts": {}}
    print(f"{n_nodes}-node graph built in {time.perf_counter() - t_start:.1f} s", flush=True)
    errs, dropped, lam = spike_step_errors(g, b, Lc, device)
    out.update(step_rel_err=errs, step_dropped=dropped, step_lambda=lam)
    print(f"{n_nodes} nodes ({hint} off-chain edges, local need {need} -> Lc {Lc}): one "
          f"step against the host float64 solve (lambda {lam:.4g}), relative error "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" (limit 1e-9), dropped {dropped}", flush=True)
    check(all(v <= 1e-9 for v in errs.values()) and dropped == 0,
          f"{n_nodes}-node SPIKE step errors {errs}, dropped {dropped}")
    caps = caps or ((2, iters) if iters < 30 else (10, 30))
    for name, (cfg, kw) in layouts.items():
        t_layout = time.perf_counter()
        def solve(c, kw=kw):
            res = optimize_se2(g, level=0, config=c, off_hint=hint, n_chain=V - 1, **kw)
            sync()
            return res

        with counted_calls(chain_lm, ("spike_core_solve", "spike_local_solve")) as calls:
            runs = [solve(cfg) for _ in range(2)]
        route = {"whole": set(), "core16": {"spike_core_solve"},
                 "auto": {"spike_local_solve"}}[name]
        check({k for k, v in calls.items() if v} == route,
              f"{n_nodes}-node {name} layout took the solves {calls}")
        (p1, s1), (p2, s2) = runs
        same = (float(s1.chi2_final) == float(s2.chi2_final) and s1.iterations == s2.iterations
                and bool(torch.equal(p1, p2)))
        ate = float(np.mean(np.linalg.norm(p1.cpu().numpy()[:n_nodes, :2] - gt[:, :2], axis=1)))
        times = {}
        for cap in caps:
            cfg_c = dataclasses.replace(cfg, max_iterations=cap, chi2_rel_tol=0.0, dx_tol=0.0)
            best, its = float("inf"), 0
            for _ in range(2):
                t0 = time.perf_counter()
                _, st = solve(cfg_c)
                best = min(best, time.perf_counter() - t0)
                its = st.iterations
            times[cap] = (best, its)
        (t1, i1), (t2, i2) = (times[c] for c in caps)
        ms_iter = (t2 - t1) * 1000.0 / max(i2 - i1, 1)
        kernels = lm_launches_per_iteration(solve, cfg) if profile else None
        rec = {"chi2_initial": float(s1.chi2_initial), "chi2": float(s1.chi2_final),
               "iterations": s1.iterations, "ate_m": ate,
               "dropped": int(s1.n_offchain_dropped), "bitwise_repeat": same,
               "ms_per_iter": ms_iter, "marginal": times, "kernels_per_iter": kernels}
        out["layouts"][name] = rec
        print(f"  {name}: chi2 {rec['chi2_initial']!r} -> {rec['chi2']!r} after "
              f"{s1.iterations} iterations, ATE {ate:.4f} m, dropped {rec['dropped']}, "
              f"bitwise repeat {same}; {ms_iter:.3f} ms/iteration (marginal {i1}->{i2}), "
              f"CUDA kernels per iteration "
              f"{'not measured' if kernels is None else kernels} "
              f"({time.perf_counter() - t_layout:.1f} s)", flush=True)
        check(same, f"{n_nodes}-node {name} layout: two solves differ")
        check(rec["dropped"] == 0, f"{n_nodes}-node {name} layout dropped off-chain edges")
    # DIVERGENCES.md section 13: one optimum across layouts (converged
    # quality), held as bench_multichip.py holds it
    tol = 1e-3 if iters >= 30 else 1e-2
    ref = out["layouts"]["whole"]["chi2"]
    for name, rec in out["layouts"].items():
        check(np.isfinite(rec["chi2"]) and abs(rec["chi2"] - ref) <= tol * ref,
              f"{n_nodes} nodes: {name} final chi2 {rec['chi2']} against the whole "
              f"chain's {ref} (tolerance {tol} relative)")
    report.setdefault("spike", {})[str(n_nodes)] = out
    return out


def prefiltered(frames, device="cuda"):
    """Phase 4's frames through the delta preset's prefilter: the clouds the
    odometry aligns."""
    from delta_graph_slam_tpu_torch.config import get_preset
    from delta_graph_slam_tpu_torch.models.prefiltering import PrefilteringStage

    stage = PrefilteringStage(get_preset("delta").prefiltering, device)
    return [stage.process(fr.points).filtered3d for fr in frames]


def multibag_drive(reg_cfg, clouds, offsets, n_steps, device="cuda"):
    """MultiBagOdometry over len(offsets) bags in lockstep for n_steps
    frames, bag b replaying ``clouds`` from frame offsets[b]
    (bench_multichip.py:205). Returns
    (odometry (steps, B, 4, 4), seconds of the timed steps, GN iterations
    of each step (steps, B))."""
    import torch

    from delta_graph_slam_tpu_torch.config import get_preset
    from delta_graph_slam_tpu_torch.parallel import MultiBagOdometry

    odo_cfg = get_preset("delta").odometry
    mb = MultiBagOdometry(reg_cfg, len(offsets),
                          keyframe_delta_trans=odo_cfg.keyframe_delta_trans,
                          keyframe_delta_angle=odo_cfg.keyframe_delta_angle)
    steps = [[clouds[k + o] for o in offsets] for k in range(n_steps)]
    mb.process(steps[0])                        # the keyframe targets
    if device != "cpu":
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    odom, its = [], []
    for step in steps[1:]:
        odom.append(mb.process(step))
        its.append(mb.last_result.iterations.tolist())
    if device != "cpu":
        torch.cuda.synchronize()
    return np.stack(odom), time.perf_counter() - t0, np.asarray(its)


def gn_kernels_per_iteration(reg_cfg, clouds, offsets):
    """CUDA kernels per GN iteration of the batched align for the bags'
    first source/target pair (torch.profiler): two aligns capped at 2 and
    4 iterations with the stop test off, the difference halved."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from delta_graph_slam_tpu_torch.parallel.multibag import _stack
    from delta_graph_slam_tpu_torch.register.engine import (
        _make_batched_align_fn, make_registration,
    )

    reg = make_registration(reg_cfg)
    tgts = _stack([reg.build_target(clouds[o]) for o in offsets])
    srcs = _stack([reg.build_source(clouds[o + 1]) for o in offsets])
    guesses = torch.eye(4, device=tgts.points.device).expand(len(offsets), 4, 4)
    counts = []
    for cap in (2, 4):
        fn = _make_batched_align_fn(dataclasses.replace(
            reg.cfg, maximum_iterations=cap, transformation_epsilon=0.0))
        fn(srcs, tgts, guesses)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            fn(srcs, tgts, guesses)
            torch.cuda.synchronize()
        counts.append(sum(e.count for e in prof.key_averages()
                          if e.device_type == DeviceType.CUDA))
    return (counts[1] - counts[0]) / 2 if counts[0] > 0 else None


def batched_nn1(report, clouds, device="cuda"):
    """The batched nn1 launch at the brute drive's shape (B problems of a
    full-capacity source against a keyframe target): against its plain
    version and against B single launches (bitwise), timed both ways
    beside the FP32 bound."""
    import torch

    from delta_graph_slam_tpu_torch.ops import knn, nn_kernel

    q = torch.stack([clouds[b + 1].points for b in range(MB_BAGS)]).contiguous()
    qm = torch.stack([clouds[b + 1].mask for b in range(MB_BAGS)]).contiguous()
    t = torch.stack([clouds[b].points for b in range(MB_BAGS)]).contiguous()
    tm = torch.stack([clouds[b].mask for b in range(MB_BAGS)]).contiguous()
    d2, idx = nn_kernel.nn_1_cuda(q, qm, t, tm)
    d2_r, idx_r = knn.nn_1_reference(q, qm, t, tm)
    singles = [nn_kernel.nn_1_cuda(q[b], qm[b], t[b], tm[b]) for b in range(MB_BAGS)]
    torch.cuda.synchronize()
    fin = torch.isfinite(d2_r)
    same_inf = bool(torch.equal(torch.isfinite(d2), fin))
    diff = (d2 - d2_r)[fin].abs()
    err = float(diff.max())
    # both versions round |q|^2 - 2 q.t + |t|^2 in float32: hold the gap to
    # 1e-6 of the expansion's magnitude (~8 float32 ulps; the prefiltered
    # scans reach 100 m, where 1e-3 m^2 is two ulps of |q|^2)
    mag = ((q * q).sum(-1) + torch.gather((t * t).sum(-1), 1, idx_r.long()))[fin]
    rel = float((diff / mag.clamp(min=1.0)).max())
    agree = float((idx[fin] == idx_r[fin]).float().mean())
    bitwise = all(torch.equal(a, d2[b]) and torch.equal(i, idx[b])
                  for b, (a, i) in enumerate(singles))
    ms = cuda_ms(lambda: nn_kernel.nn_1_cuda(q, qm, t, tm), inner=10)
    singles_ms = cuda_ms(lambda: [nn_kernel.nn_1_cuda(q[b], qm[b], t[b], tm[b])
                                  for b in range(MB_BAGS)], inner=10)
    plain_ms = cuda_ms(lambda: knn.nn_1_reference(q, qm, t, tm), reps=5, warmup=1)
    # the yardstick: B back-to-back torch.cdist(q, t).min(1) calls, one a
    # problem on its valid points (one (Nq, Nt) distance matrix at a time)
    valid = [(q[b][qm[b]], t[b][tm[b]]) for b in range(MB_BAGS)]
    library_ms = cuda_ms(lambda: [torch.cdist(a, c).min(dim=1) for a, c in valid],
                         reps=5, warmup=1)
    pairs = int((qm.sum(1) * tm.sum(1)).sum())
    flop_ms = FLOP_PER_PAIR * pairs / FP32_FLOPS * 1e3
    byte_ms = (sum(x.numel() * x.element_size() for x in (q, qm, t, tm))
               + d2.numel() * 8) / HBM_BYTES_S * 1e3
    splits, q_tiles = nn_kernel.launch_geometry(q.shape[1], t.shape[1],
                                                nn_kernel.sm_count(q.device), MB_BAGS)
    rec = {"shape": list(q.shape), "targets": t.shape[1], "valid_pairs": pairs,
           "max_abs_err": err, "max_err_over_magnitude": rel,
           "index_agreement": agree, "singles_bitwise": bitwise,
           "ms": ms, "singles_ms": singles_ms, "plain_ms": plain_ms,
           "library_ms": library_ms, "bound_ms": max(flop_ms, byte_ms),
           "bound_by": "operations" if flop_ms >= byte_ms else "bytes",
           "splits": splits, "q_tiles": q_tiles, "power_limit": smi("power.limit")}
    report["nn1_batched"] = rec
    print(f"nn1 batched, {MB_BAGS} x {q.shape[1]} x {t.shape[1]} ({pairs} valid pairs, "
          f"{splits} splits x {q_tiles} query tiles a problem): one launch {ms:.4f} ms, "
          f"{MB_BAGS} single launches {singles_ms:.4f} ms, plain {plain_ms:.3f} ms, "
          f"{MB_BAGS} torch.cdist().min(1) calls {library_ms:.3f} ms, "
          f"bound {rec['bound_ms']:.4f} ms ({100 * rec['bound_ms'] / ms:.1f}% of it); "
          f"against the plain version max |d2 err| {err:.3g}, {rel:.3g} of |q|^2 + "
          f"|t|^2 (limit 1e-6), index "
          f"agreement {agree:.5f} (limit 0.99); single launches bitwise equal {bitwise}; "
          f"power limit {rec['power_limit']}", flush=True)
    check(same_inf and rel <= 1e-6 and agree >= 0.99,
          f"batched nn1 against its plain version: inf pattern {same_inf}, error {err}, "
          f"index agreement {agree}")
    check(bitwise, "the batched nn1 launch differs from single launches")
    return err


def run_multibag(report, clouds, reference, device="cuda"):
    """Phase 14's registration half: B = 1 and B = 8 lockstep drives with
    voxel then brute correspondences, the voxel B = 8 drive held to the
    reference's. Returns the nn1 launches of the brute drives."""
    from delta_graph_slam_tpu_torch.config import get_preset
    from delta_graph_slam_tpu_torch.ops import nn_kernel

    base = get_preset("delta").odometry.registration
    launches = 0
    for method, n_steps in (("voxel", MB_STEPS), ("brute", MB_BRUTE_STEPS)):
        reg_cfg = dataclasses.replace(base, nn_method=method)
        nn_kernel.launches = 0
        single = [multibag_drive(reg_cfg, clouds, [b], n_steps, device)
                  for b in range(MB_BAGS)]
        batched = multibag_drive(reg_cfg, clouds, list(range(MB_BAGS)), n_steps, device)
        n = nn_kernel.launches
        launches += n
        odo8, dt8, its8 = batched
        gap_t = max(float(np.abs(odo8[:, b, :3, 3] - single[b][0][:, 0, :3, 3]).max())
                    for b in range(MB_BAGS))
        gap_r = max(float(np.abs(odo8[:, b, :3, :3] - single[b][0][:, 0, :3, :3]).max())
                    for b in range(MB_BAGS))
        its_same = all(np.array_equal(its8[:, b], single[b][2][:, 0]) for b in range(MB_BAGS))
        steps = n_steps - 1
        sps1 = [steps / s[1] for s in single]
        sps8 = MB_BAGS * steps / dt8
        k1 = k8 = None
        if device != "cpu":
            k1 = gn_kernels_per_iteration(reg_cfg, clouds, [0])
            k8 = gn_kernels_per_iteration(reg_cfg, clouds, list(range(MB_BAGS)))
        rec = {"scans_per_s_B1": sps1, "scans_per_s_B8": sps8,
               "scaling_B8_over_B1": sps8 / float(np.median(sps1)),
               "gn_iterations_B8": its8.tolist(), "iterations_equal": its_same,
               "max_gap_m": gap_t, "max_gap_rot": gap_r, "nn1_launches": n,
               "kernels_per_gn_iter_B1": k1, "kernels_per_gn_iter_B8": k8,
               "finite": bool(np.isfinite(odo8).all())}
        report.setdefault("multibag", {})[method] = rec
        print(f"MultiBagOdometry {method}, {steps} timed steps: B=1 median "
              f"{np.median(sps1):.2f} scans/s (bags {min(sps1):.2f}-{max(sps1):.2f}), B={MB_BAGS} "
              f"{sps8:.2f} aggregate scans/s ({rec['scaling_B8_over_B1']:.2f}x); GN "
              f"iterations a step mean {its8.mean():.2f}, equal to the B=1 drives {its_same}; "
              f"largest gap to the B=1 drives {gap_t:.3g} m, {gap_r:.3g} rotation "
              f"(limits 1e-3, 1e-4); CUDA kernels per GN iteration B=1 {k1}, "
              f"B={MB_BAGS} {k8}; nn1 launches {n}", flush=True)
        check(rec["finite"], f"MultiBagOdometry {method}: non-finite odometry")
        check(gap_t <= 1e-3 and gap_r <= 1e-4,
              f"MultiBagOdometry {method}: bags differ from their B=1 drives by "
              f"{gap_t} m, {gap_r} rotation")
        if method == "brute" and device != "cpu":
            check(n > 0, "the brute MultiBagOdometry drive launched no nn1 kernel")
        if method == "voxel":
            misses = held_to_reference("multibag_voxel", {"odom": odo8, "iters": its8},
                                       reference, report)
            check(not misses, f"MultiBagOdometry voxel against the reference: {misses}")
    return launches


def run_parallel(report, slice_frames, reference, device="cuda"):
    """Phase 14: the segmented SE2 solve in its three layouts at two sizes,
    then batched registration and the batched nn1 launch."""
    t = time.perf_counter()
    for n in (GRAPH_NODES, SPIKE_WARM_NODES):
        spike_layouts(report, n, device)
    print(f"graph layouts in {time.perf_counter() - t:.1f} s", flush=True)
    clouds = prefiltered(slice_frames, device)
    launches = run_multibag(report, clouds, reference, device)
    if device != "cpu":
        batched_nn1(report, clouds, device)
    return launches


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", help="directory for a JSON report")
    args = parser.parse_args()

    import torch

    t = phase("device")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a card")
    root = Path(__file__).resolve().parent
    if not (root / "delta_graph_slam_tpu_torch" / "csrc" / "nn1.cu").exists():
        fail(f"the port's sources are not beside this script in {root}")
    sys.path.insert(0, str(root))
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}", flush=True)
    report = {"nvidia_smi": smi_line, "kernel_cases": {}}
    reference, ref_meta = load_reference(root / REFERENCE_FILE)
    print("reference drives: JAX {} on the {}, x64 {}, partitionable threefry {}, "
          "recorded in {:.0f} s by {}".format(
              ref_meta["jax_version"], ref_meta["platform"], ref_meta["x64"],
              ref_meta["threefry_partitionable"], float(ref_meta["seconds"]),
              ref_meta["command"]), flush=True)

    from delta_graph_slam_tpu_torch.ops import nn_kernel

    t = phase("build")
    lib = nn_kernel.build()
    build_s = time.perf_counter() - t
    print(f"built {lib.relative_to(root)} in {build_s:.2f} s", flush=True)
    log = lib.with_name(lib.name + ".log")
    ptxas = [ln.strip() for ln in log.read_text().splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    print("\n".join(ptxas), flush=True)
    report.update(build_s=build_s, ptxas=ptxas)

    t = phase("kernel vs plain")
    err, timing = kernel_vs_plain(report)
    print(f"phase done in {time.perf_counter() - t:.1f} s", flush=True)

    t = phase("slice: 40 frames, delta preset, full capacity")
    launches, slice_frames = run_slice(report, reference)
    voxel_sums(report)
    print(f"phase done in {time.perf_counter() - t:.1f} s", flush=True)

    t = phase("small input: card vs plain CPU path")
    small_check(report)
    print(f"phase done in {time.perf_counter() - t:.1f} s", flush=True)

    t = phase(f"graph solve: {GRAPH_NODES}-node two-lap graph, chain backend")
    graph_solve(report)
    print(f"phase done in {time.perf_counter() - t:.1f} s", flush=True)

    t = phase(f"backend drive: {LAP_FRAMES}-frame raycast lap, no buildings")
    from delta_graph_slam_tpu_torch.io.lidar_sim import raycast_city_sequence

    _, lap = raycast_city_sequence(n_frames=LAP_FRAMES, trajectory="lap",
                                   turn_frames=20, speed=3.0, gps_noise_std=0.5,
                                   gps_walk_std=0.15)
    print(f"generated {LAP_FRAMES} frames in {time.perf_counter() - t:.1f} s",
          flush=True)
    launches += run_backend(report, lap, reference)
    print(f"phase done in {time.perf_counter() - t:.1f} s", flush=True)

    t = phase(f"buildings: {CITY_FRAMES}-frame raycast city drive, delta preset")
    threefry_draws(report)
    world, city, city_gts = city_frames()
    n, serial_city = run_buildings(report, world, city, city_gts, reference)
    launches += n
    print(f"phase done in {time.perf_counter() - t:.1f} s", flush=True)

    t = phase(f"SE3 graph solve: {GRAPH_NODES}-node hdl graph, chain + hub backend")
    se3_graph_solve(report)
    se3_lm_capture(report)
    print(f"phase done in {time.perf_counter() - t:.1f} s", flush=True)

    t = phase(f"hdl drive: {CITY_FRAMES}-frame raycast city drive, hdl_400, then "
              f"{IMU_FRAMES} frames of hdl_imu")
    n, serial_hdl = run_hdl(report, city, city_gts, reference)
    launches += n
    print(f"phase done in {time.perf_counter() - t:.1f} s", flush=True)

    t = phase(f"registration heads: NDT_OMP and FAST_VGICP odometry on {N_FRAMES} frames, "
              f"the NDT backend registration on the {LAP_FRAMES}-frame lap")
    launches += run_heads(report, slice_frames, lap, reference)
    print(f"phase done in {time.perf_counter() - t:.1f} s", flush=True)

    t = phase(f"threaded runner: the building drive and the hdl_400 drive, "
              f"{CITY_FRAMES} frames each")
    launches += run_threaded(report, world, city, city_gts, serial_city, serial_hdl)
    print(f"phase done in {time.perf_counter() - t:.1f} s", flush=True)

    t = phase(f"host runtime: libpcio, the command line on {CLI_FRAMES} recorded frames, "
              f"a checkpoint after {RESUME_AT} frames, the 'dense' methods")
    launches += run_host_runtime(report, slice_frames, world, city, city_gts, reference)
    print(f"phase done in {time.perf_counter() - t:.1f} s", flush=True)

    t = phase(f"parallel: SE2 layouts at {GRAPH_NODES} and {SPIKE_WARM_NODES} nodes, "
              f"MultiBagOdometry B=1 and B={MB_BAGS}, the batched nn1 launch")
    launches += run_parallel(report, slice_frames, reference)
    print(f"phase done in {time.perf_counter() - t:.1f} s", flush=True)

    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    batched = report["nn1_batched"]
    print(json.dumps({"kernels": [{
        "name": "nn1", "route": "cuda",
        "source": "delta_graph_slam_tpu_torch/csrc/nn1.cu",
        "replaces": REPLACES, "launches": launches,
        "max_abs_err": max(err, batched["max_abs_err"]),
        **{k: timing[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                  "library_ms", "bound_share")},
        **{f"batched_{k}": batched[k] for k in ("ms", "singles_ms", "plain_ms",
                                                "library_ms", "bound_ms", "shape")},
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
