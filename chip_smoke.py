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
     32768 x 32768 and at ragged, self-excluding and target-less shapes;
     both timed with CUDA events;
  4. the slice: 40 raycast frames through Pipeline(get_preset('delta'),
     device='cuda') at full capacity, then finish(); checks the odometry
     edges, the kernel launch count of that run, convergence and drift;
  5. small input: the same slice at a small size on the card and through
     the plain CPU path, which must agree.
The line before the last is the kernel report, the last line the result.
With --out, a JSON file with every measurement goes into DIR.
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

N_FRAMES = 40
REPLACES = "delta_graph_slam_tpu/ops/pallas_nn.py:30"


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond, msg):
    if not cond:
        fail(msg)


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


def cuda_ms(fn, reps=20, warmup=3):
    """Median milliseconds of ``fn`` on the card over ``reps`` runs."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def nn_cases(rng):
    """(name, query, qmask, target, tmask, exclude_self) on the host."""
    def box(n):
        # a street-sized box: |p|^2 stays below ~1.3e3 m^2, where float32
        # rounding of |q|^2 - 2q.t + |t|^2 stays well under the 1e-3 limit
        return np.stack([rng.uniform(-25, 25, n), rng.uniform(-25, 25, n),
                         rng.uniform(-2, 3, n)], 1).astype(np.float32)

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
        ("exclude_self_8192", self_pts, self_mask, self_pts, self_mask, True),
        ("all_targets_invalid", q1, rng.random(1000) > 0.1, t1,
         np.zeros(3001, bool), False),
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
        report["kernel_cases"][name] = {"max_abs_err": err, "index_agreement": agree}
    # times at the fitness shape, the one every odometry edge runs
    _, q, qm, t, tm, _ = nn_cases(np.random.default_rng(0))[0]
    args = [torch.from_numpy(x).cuda() for x in (q, qm, t, tm)]
    ms = cuda_ms(lambda: nn_kernel.nn_1_cuda(*args))
    plain_ms = cuda_ms(lambda: knn.nn_1_reference(*args))
    print(f"nn1 at 32768x32768: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms "
          f"(median of 20, CUDA events)", flush=True)
    return worst, ms, plain_ms


def rel_gt(frames):
    from delta_graph_slam_tpu_torch.geom.host import se2_compose_np, se2_inverse_np

    g0 = se2_inverse_np(frames[0].gt_pose)
    return [se2_compose_np(g0, fr.gt_pose) for fr in frames]


def odometry_edges(backend):
    return [e for e in backend.graph.edges if e["id"] != backend.anchor_edge_id]


def run_slice(report):
    import torch

    from delta_graph_slam_tpu_torch.config import get_preset
    from delta_graph_slam_tpu_torch.io.lidar_sim import raycast_city_sequence
    from delta_graph_slam_tpu_torch.ops import nn_kernel
    from delta_graph_slam_tpu_torch.pipeline.runner import Pipeline

    t0 = time.perf_counter()
    _, frames = raycast_city_sequence(n_frames=N_FRAMES, speed=3.0)
    print(f"generated {N_FRAMES} raycast frames in "
          f"{time.perf_counter() - t0:.1f} s (host numpy; "
          f"{np.mean([len(f.points) for f in frames]):.0f} returns/frame)",
          flush=True)
    cfg = get_preset("delta")
    # warm-up on a throw-away pipeline: CUDA context, cuBLAS, allocator
    warm = Pipeline(cfg, device="cuda")
    for fr in frames[:3]:
        warm.on_points(fr.stamp, fr.points)
    warm.finish()
    torch.cuda.synchronize()

    pipe = Pipeline(cfg, device="cuda")
    torch.cuda.reset_peak_memory_stats()
    nn_kernel.launches = 0
    t0 = time.perf_counter()
    odo = [pipe.on_points(fr.stamp, fr.points) for fr in frames]
    pipe.finish()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = nn_kernel.launches

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
        "drift_m": drift, "path_m": path, "gn_iterations": iters,
        "peak_mem_bytes": torch.cuda.max_memory_allocated(),
    }
    check(len(finite) >= 4, f"{len(finite)} odometry edges with finite "
          "information, need 4")
    check(launches >= len(edges),
          f"nn1 launched {launches} times for {len(edges)} edges")
    check(converged >= 0.9, f"only {converged:.3f} of frames converged")
    check(drift <= 0.05 * path, f"drift {drift:.3f} m > 5% of {path:.3f} m")
    return launches


def small_check(report):
    """The slice at a small size on the card (kernel) and on the CPU
    (plain versions): the same odometry and edges within the parity
    tolerances of tests/test_torch_pipeline.py."""
    import dataclasses

    from delta_graph_slam_tpu_torch.config import get_preset
    from delta_graph_slam_tpu_torch.io.lidar_sim import raycast_city_sequence
    from delta_graph_slam_tpu_torch.pipeline.runner import Pipeline

    cfg = get_preset("delta")
    cfg = dataclasses.replace(
        cfg,
        prefiltering=dataclasses.replace(cfg.prefiltering, raw_capacity=16384,
                                         out_capacity=4096, chunk=1024),
        delta=dataclasses.replace(cfg.delta, keyframe_delta_trans=1.0,
                                  keyframe_delta_angle=1.0),
    )
    _, frames = raycast_city_sequence(n_frames=10, speed=3.0, seed=5)
    runs = []
    for device in ("cuda", "cpu"):
        pipe = Pipeline(cfg, device=device)
        odo = [pipe.on_points(fr.stamp, fr.points) for fr in frames]
        pipe.finish()
        runs.append((odo, odometry_edges(pipe.backend)))
    (odo_g, edges_g), (odo_c, edges_c) = runs
    eps = cfg.odometry.registration.transformation_epsilon
    worst = 0.0
    for k, (g, c) in enumerate(zip(odo_g, odo_c)):
        dt = float(np.abs(g.pose[:3, 3] - c.pose[:3, 3]).max())
        worst = max(worst, dt)
        lim = 1e-2 if g.iterations == c.iterations else eps
        check(dt < lim, f"small check frame {k}: card and CPU poses {dt} m apart")
    check(len(edges_g) == len(edges_c) >= 2,
          f"small check: {len(edges_g)} vs {len(edges_c)} odometry edges")
    for eg, ec in zip(edges_g, edges_c):
        check(np.allclose(eg["info"], ec["info"], rtol=1e-3),
              "small check: information matrices differ beyond rtol 1e-3")
    print(f"small check: card vs CPU poses within {worst:.2e} m, "
          f"{len(edges_g)} odometry edges agree", flush=True)
    report["small_check"] = {"max_pose_gap_m": worst, "edges": len(edges_g)}


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

    from delta_graph_slam_tpu_torch.ops import nn_kernel

    t = phase("build")
    lib = nn_kernel.build()
    build_s = time.perf_counter() - t
    print(f"built {lib.relative_to(root)} in {build_s:.2f} s", flush=True)
    report["build_s"] = build_s

    t = phase("kernel vs plain")
    err, ms, plain_ms = kernel_vs_plain(report)
    report.update(nn1_ms=ms, nn1_plain_ms=plain_ms)
    print(f"phase done in {time.perf_counter() - t:.1f} s", flush=True)

    t = phase("slice: 40 frames, delta preset, full capacity")
    launches = run_slice(report)
    print(f"phase done in {time.perf_counter() - t:.1f} s", flush=True)

    t = phase("small input: card vs plain CPU path")
    small_check(report)
    print(f"phase done in {time.perf_counter() - t:.1f} s", flush=True)

    if args.out:
        out = Path(args.out)
        out.mkdir(parents=True, exist_ok=True)
        (out / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    print(json.dumps({"kernels": [{
        "name": "nn1", "route": "cuda",
        "source": "delta_graph_slam_tpu_torch/csrc/nn1.cu",
        "replaces": REPLACES, "launches": launches, "max_abs_err": err,
        "ms": ms, "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
