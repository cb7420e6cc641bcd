#!/usr/bin/env python3
"""The SE3 LM iteration of the PyTorch port, eager and replayed as a CUDA graph.

    python3 scripts/se3_lm_capture.py [--device cuda|cpu]

On the card (the default):
  - chip_smoke.py phase 9's comparison (``se3_lm_capture``) at 4096 nodes;
  - the hdl backend's per-cycle graph (40 keyframes, a plane edge on every
    keyframe, packed at HdlBackend's capacities: v 256, e 512, prior 512,
    off-chain floor 64) solved to convergence with every iteration eager
    and with the iteration replayed: iterations, chi2, seconds a solve,
    whether the states are bitwise equal; ms an iteration (solves capped
    at 2 and 10 iterations, best of 3) and CUDA kernels an iteration
    (chip_smoke.lm_launches_per_iteration), both ways;
  - the replayed solve four times while another thread launches products
    and allocations on the default stream: bitwise equal to the solo one;
  - the torch.profiler table of a 6-iteration replayed solve.
On the CPU (no card needed): ATen ops an LM iteration of the same backend
graph, counted by a TorchDispatchMode over solves capped at 2 and 4
iterations, a proxy for the card's launches.
"""

import argparse
import collections
import dataclasses
import sys
import threading
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402  (the numpy graph builders at the repo root)
from delta_graph_slam_tpu_torch.graph import SolverConfig, optimize_se3  # noqa: E402

SOLVER = SolverConfig(backend="chain", max_iterations=100, chi2_rel_tol=1e-6)


def backend_graph(device):
    b = cs.se3_graph_builder(cs.bench_graph_se3(40, plane_every=1), device)
    g = b.to_arrays(dtype=np.float32, v_capacity=256, e_capacity=512, prior_capacity=512)
    n_off = b.count_offchain()

    def solve(c, cuda_graph=True):
        out = optimize_se3(g, config=c, offrank_floor=64, n_offchain=n_off,
                           cuda_graph=cuda_graph)
        if device == "cuda":
            torch.cuda.synchronize()
        return out
    return solve


def uncapped(cap):
    return dataclasses.replace(SOLVER, max_iterations=cap, chi2_rel_tol=0.0, dx_tol=0.0)


def cpu_ops():
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func)] += 1
            return func(*args, **(kwargs or {}))

    solve = backend_graph("cpu")
    counts = []
    for cap in (2, 4):
        with Count() as c:
            solve(uncapped(cap))
        counts.append(c.ops)
    per = {k: (counts[1][k] - counts[0][k]) / 2 for k in counts[1]}
    print(f"ATen ops an SE3 LM iteration on the CPU: {sum(per.values())}", flush=True)
    for name, n in sorted(per.items(), key=lambda kv: -kv[1])[:15]:
        print(f"{n:8.1f} {name}")


def card():
    from torch.profiler import ProfilerActivity, profile

    print(cs.smi("name,power.limit"), torch.__version__, torch.version.cuda, flush=True)
    t0 = time.perf_counter()
    cs.se3_lm_capture({})
    print(f"se3_lm_capture {time.perf_counter() - t0:.1f} s", flush=True)

    solve = backend_graph("cuda")
    res = {}
    for cuda_graph in (False, True):
        solve(SOLVER, cuda_graph)
        secs = []
        for _ in range(3):
            t0 = time.perf_counter()
            state, st = solve(SOLVER, cuda_graph)
            secs.append(time.perf_counter() - t0)
        res[cuda_graph] = (state, st)
        print(f"backend graph, cuda_graph={cuda_graph}: {st.iterations} iterations, chi2 "
              f"{float(st.chi2_final)!r}, seconds a solve {secs}", flush=True)
    print("backend graph bitwise equal:", all(
        torch.equal(a, c) for a, c in zip(res[False][0], res[True][0])), flush=True)
    for cuda_graph in (False, True):
        best = {}
        for cap in (2, 10):
            for _ in range(3):
                t0 = time.perf_counter()
                solve(uncapped(cap), cuda_graph)
                best[cap] = min(best.get(cap, float("inf")), time.perf_counter() - t0)
        print(f"backend graph, cuda_graph={cuda_graph}: {(best[10] - best[2]) * 125.0:.3f} ms "
              f"an iteration, a 2-iteration solve {best[2] * 1000.0:.1f} ms, CUDA kernels an "
              f"iteration {cs.lm_launches_per_iteration(lambda c: solve(c, cuda_graph), SOLVER)}",
              flush=True)

    stop = threading.Event()

    def other_thread():
        x = torch.randn(512, 512, device="cuda")
        while not stop.is_set():
            y = x @ x
            z = torch.empty(1 << 20, device="cuda")
            del y, z

    th = threading.Thread(target=other_thread, daemon=True)
    th.start()
    try:
        outs = [solve(SOLVER, True) for _ in range(4)]
    finally:
        stop.set()
        th.join(10)
    ref_state, ref_st = res[True]
    print("beside another thread, bitwise equal to the solo solve:", all(
        all(torch.equal(a, c) for a, c in zip(s, ref_state)) and st.iterations == ref_st.iterations
        for s, st in outs), flush=True)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve(uncapped(6), True)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=30,
                                    max_name_column_width=70), flush=True)
    print(f"memory reserved {torch.cuda.memory_reserved() / 2**20:.1f} MiB", flush=True)
    print(cs.smi("name,power.limit"))


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = parser.parse_args()
    if args.device == "cpu":
        cpu_ops()
    else:
        if not torch.cuda.is_available():
            sys.exit("no card: torch.cuda.is_available() is False (use --device cpu)")
        card()


if __name__ == "__main__":
    main()
