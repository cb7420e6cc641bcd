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
  4. the front end: 40 raycast frames through Pipeline(get_preset('delta'),
     device='cuda') at full capacity, GPS fed every frame, then finish();
     checks the odometry edges, the kernel launch count of that run,
     convergence and drift;
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
     is printed beside it;
  8. buildings: the delta preset with OSM buildings on (RANSAC lines,
     align_global per keyframe, keyframe<->building edges, global priors,
     the de-overlap loop, save_map), 10 warm-up frames then 240 timed
     raycast frames of bench.py's city drive (GPS 0.5 m noise, 0.15 m/frame
     walk), then finish(); needs >= 3 building vertices, >= 1
     keyframe<->building edge, >= 1 global prior, align_global on every
     keyframe with buildings in range, finite chi2 on every cycle, <= 15
     de-overlap rounds a cycle, ATE <= 1.0 m and three non-empty PCD
     files; the same frames without buildings are printed beside it.
The line before the last is the kernel report, the last line the result.
With --out, a JSON file with every measurement goes into DIR.
"""

import argparse
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
EMPTY_OSM = "<osm></osm>"
GRAPH_NODES = 4096
LAP_FRAMES = 120
CITY_WARMUP = 10
CITY_FRAMES = 240


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


def make_pipeline(cfg, device="cuda"):
    """The delta pipeline on ``device`` in a world without OSM buildings."""
    from delta_graph_slam_tpu_torch.buildings import StaticProvider
    from delta_graph_slam_tpu_torch.pipeline.runner import Pipeline

    return Pipeline(cfg, building_provider=StaticProvider(EMPTY_OSM),
                    device=device)


def drive(pipe, frames, gts=None):
    """GPS then the scan of every frame; returns the odometry frames."""
    out = []
    for k, fr in enumerate(frames):
        pipe.on_gps(fr.stamp, *fr.gps)
        out.append(pipe.on_points(fr.stamp, fr.points,
                                  gt_pose=None if gts is None else gts[k]))
    return out


def run_slice(report):
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
    # warm-up on a throw-away pipeline: CUDA context, cuBLAS, allocator
    warm = make_pipeline(cfg)
    drive(warm, frames[:3])
    warm.finish()
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
    runs = []
    for device in ("cuda", "cpu"):
        pipe = make_pipeline(cfg, device)
        odo = drive(pipe, frames)
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

def count_loop_edges(backend):
    """SE2 edges between non-consecutive keyframe vertices."""
    nodes = [k.node_id for k in backend.keyframes]
    consecutive = {frozenset(p) for p in zip(nodes[1:], nodes[:-1])}
    kf = set(nodes)
    return sum(1 for e in backend.graph.edges
               if e["type"] == "se2" and e["i"] in kf and e["j"] in kf
               and frozenset((e["i"], e["j"])) not in consecutive)


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


def run_backend(report, frames):
    from delta_graph_slam_tpu_torch.ops import nn_kernel

    gts = rel_gt(frames)
    nn_kernel.launches = 0
    pipe, cycles, loop_launches, wall = backend_drive(frames, gts)
    launches = nn_kernel.launches
    be = pipe.backend
    m = pipe.evaluate()
    loops = count_loop_edges(be)
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
          f"loop edges {count_loop_edges(pipe_o.backend)}", flush=True)
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
    return launches


# ---------------------------------------------------------- buildings drive

def city_drive(world, frames, gts, buildings=True):
    """bench.py:127-187 without its compile pass: the delta preset at full
    capacity, CITY_WARMUP frames and two update steps, the timers reset,
    then the timed frames and finish(). Returns (pipeline, non-empty
    per-cycle stats, wall seconds of the timed frames)."""
    import torch

    from delta_graph_slam_tpu_torch.buildings import StaticProvider
    from delta_graph_slam_tpu_torch.config import get_preset
    from delta_graph_slam_tpu_torch.pipeline.runner import Pipeline

    cfg = get_preset("delta")
    if not buildings:     # the no_buildings variant of bench.py:190-218
        cfg = dataclasses.replace(cfg, delta=dataclasses.replace(
            cfg.delta, enable_buildings=False))
    pipe = Pipeline(cfg, building_provider=StaticProvider(
        world.osm_xml() if buildings else EMPTY_OSM), device="cuda")
    cycles, step = [], pipe.backend.optimization_step

    def counted_step():
        out = step()
        cycles.append(out)
        return out

    pipe.backend.optimization_step = counted_step
    drive(pipe, frames[:CITY_WARMUP], gts[:CITY_WARMUP])
    pipe.backend.optimization_step()
    pipe.backend.optimization_step()
    pipe.timer.reset()
    pipe.backend.timer.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for fr, gt in zip(frames[CITY_WARMUP:], gts[CITY_WARMUP:]):
        pipe.on_gps(fr.stamp, *fr.gps)
        pipe.on_points(fr.stamp, fr.points, gt_pose=gt)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pipe.finish()
    return pipe, [c for c in cycles if c], wall


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


def run_buildings(report):
    import tempfile

    from delta_graph_slam_tpu_torch.io.lidar_sim import raycast_city_sequence
    from delta_graph_slam_tpu_torch.io.pcd import load_pcd
    from delta_graph_slam_tpu_torch.ops import nn_kernel

    t0 = time.perf_counter()
    world, frames = raycast_city_sequence(n_frames=CITY_WARMUP + CITY_FRAMES, speed=3.0,
                                          gps_noise_std=0.5, gps_walk_std=0.15)
    gts = rel_gt(frames)          # re-anchored as bench.py:80-95
    print(f"generated {len(frames)} frames in {time.perf_counter() - t0:.1f} s",
          flush=True)
    nn_kernel.launches = 0
    pipe, cycles, wall = city_drive(world, frames, gts)
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

    pipe_n, _, wall_n = city_drive(world, frames, gts, buildings=False)
    m_n = pipe_n.evaluate()
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
    launches += run_backend(report, lap)
    print(f"phase done in {time.perf_counter() - t:.1f} s", flush=True)

    t = phase(f"buildings: {CITY_FRAMES}-frame raycast city drive, delta preset")
    launches += run_buildings(report)
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
