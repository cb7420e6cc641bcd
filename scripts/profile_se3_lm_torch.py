#!/usr/bin/env python3
"""Where an SE3 LM iteration of the PyTorch port spends its time on the card.

    python3 scripts/profile_se3_lm_torch.py [NODES] [--backend-capacities]

Builds the hdl bench graph of chip_smoke.py (bench_graph_se3) at NODES
vertices (default 4096) on the card, solves it with the chain + hub backend
and the early exits off, and prints
  - ms per LM iteration, twice: the wall-clock difference of a solve capped
    at 2 iterations and one capped at 6, over the 4 iterations between;
  - the torch.profiler tables of one 4-iteration solve, by device time and by
    host time (launch count: the cudaLaunchKernel row).
--backend-capacities packs the graph as HdlBackend does (v 256, e 512, prior
512, off-chain floor 64) with a plane edge on every keyframe; use it with a
small NODES (40) for the backend's per-cycle solve.
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402  (the numpy graph builders at the repo root)
from delta_graph_slam_tpu_torch.graph import SolverConfig, optimize_se3  # noqa: E402


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("nodes", nargs="?", type=int, default=4096)
    parser.add_argument("--backend-capacities", action="store_true")
    args = parser.parse_args()

    as_backend = args.backend_capacities
    graph = chip_smoke.bench_graph_se3(args.nodes, plane_every=1 if as_backend else 4)
    b = chip_smoke.se3_graph_builder(graph, "cuda")
    caps = dict(v_capacity=256, e_capacity=512, prior_capacity=512) if as_backend else {}
    g = b.to_arrays(dtype=np.float32, **caps)
    n_off = b.count_offchain()

    def solve(cap):
        cfg = SolverConfig(backend="chain", max_iterations=cap, chi2_rel_tol=0.0,
                           dx_tol=0.0)
        t0 = time.perf_counter()
        optimize_se3(g, config=cfg, offrank_floor=64 if as_backend else 0,
                     n_offchain=n_off)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    solve(2)                                    # warm-up
    for _ in range(2):
        t2, t6 = solve(2), solve(6)
        print(f"{args.nodes} nodes: {(t6 - t2) * 250.0:.1f} ms per LM iteration "
              f"(2 iterations {t2:.3f} s, 6 iterations {t6:.3f} s)", flush=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        solve(4)
    averages = prof.key_averages()
    for key in ("cuda_time_total", "self_cpu_time_total"):
        print(averages.table(sort_by=key, row_limit=25, max_name_column_width=60))
    print(chip_smoke.smi("name,power.limit"))


if __name__ == "__main__":
    main()
