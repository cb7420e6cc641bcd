"""The automatic SPIKE route of the port's optimize_se2 against the JAX
package's, and the delta backend's hint that enables it.

Graphs of at least SPIKE_AUTO_MIN_N = 2048 vertices with off-chain edges
and a local_hint are solved by the locality-aware segmented solve
(parallel/spike.py, 16 segments) in both packages. The graph is chip
smoke's bench graph (two laps, Huber loops every 100 nodes) at 2048
nodes; the JAX package's program compiles once (~40 s on a CPU).
"""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import torch

from delta_graph_slam_tpu.graph import SE2GraphBuilder as RBuilder
from delta_graph_slam_tpu.graph import SolverConfig as RConfig
from delta_graph_slam_tpu.graph import optimize_se2 as r_optimize
from delta_graph_slam_tpu.graph import solver as r_solver
from delta_graph_slam_tpu.models import delta_backend as r_backend_mod
from delta_graph_slam_tpu_torch.graph import SolverConfig, optimize_se2
from delta_graph_slam_tpu_torch.graph import chain_lm
from delta_graph_slam_tpu_torch.graph import solver as p_solver
from delta_graph_slam_tpu_torch.graph.chain_solve import chain_core_solve, finish_tridiag
from delta_graph_slam_tpu_torch.graph.solver import _free_mask, _graph_f64
from delta_graph_slam_tpu_torch.interop import builder_from_reference
from delta_graph_slam_tpu_torch.models import delta_backend as p_backend_mod
from delta_graph_slam_tpu_torch.parallel import spike

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402  (the numpy bench graph)

torch.set_num_threads(2)
N_AUTO = 2048


def bench_builders(n):
    init, edges, gt = chip_smoke.bench_graph(n)
    rb = RBuilder()
    for k, p in enumerate(init):
        rb.add_vertex(p, fixed=(k == 0))
    for i, j, m, kern in edges:
        rb.add_se2_edge(i, j, m, chip_smoke.GRAPH_INFO, kernel=kern, delta=1.0)
    return rb, builder_from_reference(rb), gt


def test_auto_route_constants_match_reference():
    assert (p_solver.SPIKE_AUTO_P, p_solver.SPIKE_AUTO_MIN_N,
            p_solver.SPIKE_AUTO_MAX_LC) == (r_solver.SPIKE_AUTO_P,
                                             r_solver.SPIKE_AUTO_MIN_N,
                                             r_solver.SPIKE_AUTO_MAX_LC)


def test_optimize_se2_auto_route_matches_reference(monkeypatch):
    rb, pb, gt = bench_builders(N_AUTO)
    rg, pg = rb.to_arrays(chain_first=True), pb.to_arrays(chain_first=True)
    V = pg.poses.shape[0]
    assert V == rg.poses.shape[0] >= N_AUTO
    off_hint = pb.count_offchain(0)
    local_hint = pb.spike_local_need(V, 0)
    assert (off_hint, local_hint) == (rb.count_offchain(0), rb.spike_local_need(V, 0))
    calls = []
    real = chain_lm.spike_local_solve

    def spy(*a, **kw):
        calls.append((kw["p"], kw["Lc"]))
        return real(*a, **kw)

    monkeypatch.setattr(chain_lm, "spike_local_solve", spy)
    cfg = dict(backend="chain", max_iterations=10)
    wp, ws = r_optimize(rg, level=0, config=RConfig(**cfg), off_hint=off_hint,
                        n_chain=V - 1, local_hint=local_hint)
    gp, gs = optimize_se2(pg, level=0, config=SolverConfig(**cfg), off_hint=off_hint,
                          n_chain=V - 1, local_hint=local_hint)
    # the route: 16 segments, the slot capacity bucketed from 8
    assert calls and set(calls) == {(16, 8)}
    assert int(gs.n_offchain_dropped) == int(ws.n_offchain_dropped) == 0
    np.testing.assert_allclose(float(gs.chi2_initial), float(ws.chi2_initial), rtol=1e-12)
    # the same layout in both packages: every step agrees to ~1e-9
    # relative (DIVERGENCES.md section 13), so the runs take the same
    # iterations and reach the same chi2 to 1e-9 relative
    assert gs.iterations == int(ws.iterations) > 3
    np.testing.assert_allclose(float(gs.chi2_final), float(ws.chi2_final), rtol=1e-9)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=0, atol=1e-6)


def test_auto_route_step_matches_whole_chain_step():
    """One LM step of the bench graph: the segmented solves (the route's
    locality-aware one and the core one) against the whole-chain solve of
    the same system, to 1e-9 of the step (DIVERGENCES.md section 13)."""
    _, pb, _ = bench_builders(N_AUTO)
    g = pb.to_arrays(chain_first=True)
    V = g.poses.shape[0]
    K_cap = 24
    graph = _graph_f64(g)
    free = _free_mask(graph, 0)
    cr, tail, chi2 = chain_lm._residual_pass(graph, graph.poses, 0, V - 1)
    bundle, t_off = chain_lm._assemble_bundle(graph, cr, tail, chi2, V - 1, V,
                                              (free > 0).any(dim=1))
    order = torch.argsort((~t_off).to(torch.int32), stable=True)[:K_cap]
    gate = t_off[order][:, None, None].to(torch.float64)
    off = (tail.i[order], tail.j[order], tail.Ji[order] * gate, tail.Jj[order] * gate,
           tail.W[order] * gate)
    A, B = finish_tridiag(bundle.A0, bundle.B0, free, torch.tensor(1e-3, dtype=torch.float64))
    whole = chain_core_solve(A, B, -bundle.b, free, V, off=off)
    local, dropped = spike.spike_local_solve(A, B, -bundle.b, free, V, 16, off, 8)
    core = spike.spike_core_solve(A, B, -bundle.b, free, V, 16, off=off)
    assert int(dropped) == 0
    scale = float(whole.abs().max())
    assert float((local - whole).abs().max()) <= 1e-9 * scale
    assert float((core - whole).abs().max()) <= 1e-9 * scale


def capture_hints(monkeypatch, module, backend):
    """Run backend._optimize(0) with the module's optimize_se2 replaced by
    a recorder; returns the keyword arguments it was called with."""
    seen = {}

    def record(g, level=0, config=None, **kw):
        seen.update(kw, V=g.poses.shape[0])
        return g.poses, None

    monkeypatch.setattr(module, "optimize_se2", record)
    backend._optimize(0)
    return seen


def test_delta_backend_passes_the_reference_local_hint(monkeypatch):
    """The port's DeltaBackend asks for the same route as the reference's:
    the same off_hint, n_chain and local_hint on one 3000-keyframe graph."""
    rb = RBuilder()
    for k in range(3000):
        rb.add_vertex(np.asarray([k * 1.0, 0.0, 0.0]), fixed=(k == 0))
    for k in range(2999):
        rb.add_se2_edge(k, k + 1, np.asarray([1.0, 0.0, 0.0]), np.eye(3))
    for k in range(10, 1500, 70):
        rb.add_se2_edge(k, k + 1400, np.asarray([1400.0, 0.0, 0.0]), np.eye(3),
                        kernel="Huber", delta=1.0)
    r_cfg = r_backend_mod.DeltaBackendConfig()
    p_cfg = p_backend_mod.DeltaBackendConfig()
    assert r_cfg.solver.backend == p_cfg.solver.backend == "chain"
    r_be = r_backend_mod.DeltaBackend(r_cfg)
    p_be = p_backend_mod.DeltaBackend(p_cfg, device="cpu")
    r_be.graph, p_be.graph = rb, builder_from_reference(rb)
    want = capture_hints(monkeypatch, r_backend_mod, r_be)
    got = capture_hints(monkeypatch, p_backend_mod, p_be)
    assert want["V"] == got["V"] == 4096
    assert want["local_hint"] is not None and want["local_hint"] > 0
    for key in ("off_hint", "n_chain", "local_hint"):
        assert got[key] == want[key], key


def test_optimize_se2_explicit_segments_matches_whole_chain():
    """An explicit chain_segments solves a small graph through the
    segmented solve (core, then locality-aware) to the whole chain's
    optimum (DIVERGENCES.md section 13: the same converged chi2)."""
    _, pb, _ = bench_builders(256)
    g = pb.to_arrays(chain_first=True)
    V, hint = g.poses.shape[0], pb.count_offchain(0)
    base = SolverConfig(backend="chain", max_iterations=25)
    _, s1 = optimize_se2(g, config=base, off_hint=hint, n_chain=V - 1)
    for extra in (dict(chain_segments=4), dict(chain_segments=4, chain_local_cols=8)):
        _, s4 = optimize_se2(g, config=dataclasses.replace(base, **extra),
                             off_hint=hint, n_chain=V - 1)
        assert int(s4.n_offchain_dropped) == 0
        np.testing.assert_allclose(float(s4.chi2_final), float(s1.chi2_final), rtol=1e-6)
    # three loops leaving one 16-vertex segment and one slot a segment:
    # the two that overflow are dropped, and the stats say so
    for i, j in ((40, 200), (41, 210), (42, 220)):
        pb.add_se2_edge(i, j, np.asarray([1.0, 0.0, 0.0]), np.eye(3))
    g = pb.to_arrays(chain_first=True)
    _, s2 = optimize_se2(g, config=dataclasses.replace(base, chain_segments=16,
                                                       chain_local_cols=1),
                         off_hint=pb.count_offchain(0), n_chain=g.poses.shape[0] - 1)
    assert int(s2.n_offchain_dropped) == 2
