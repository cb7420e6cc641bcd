"""Level-masked robust LM for SE2 pose graphs (on the lm_core machinery).

Replaces g2o's OptimizationAlgorithmLevenberg + CHOLMOD for the delta
backend (GraphSLAM::optimize, graph_slam.cpp:338-352), with g2o's
semantics: additive SE2 updates with angle normalization, level masking
(initializeOptimization(level) keeps edges whose level == level), fixed
vertices, robust kernels through IRLS weights.

The solver state is float64 poses whatever the table dtype (the JAX
package keeps a double-float state for the same reason: metric-scale
residuals cancel catastrophically in float32).
"""

import dataclasses
import math

import torch

from ..geom.se2 import normalize_angle
from ..ops.segment import deterministic
from .lm_core import (
    SolverConfig, SolverStats, concat_sys, lm_optimize, pad_block,
)
from .robust import robust_rho, robust_weight
from .se2_graph import SE2Graph

_TWO_PI = 2.0 * math.pi


def _se2_edge_err_jac(pi, pj, meas, with_jac=True):
    """Residual and analytic Jacobians of se2_edge_error, vectorized.

    e_xy = R(-th_m)(R(-th_i)(tj - ti) - t_m): d e_xy/d t_i = -R(-th_m)R(-th_i),
    d e_xy/d th_i = R(-th_m) [ty, -tx]."""
    dx = pj[:, 0] - pi[:, 0]
    dy = pj[:, 1] - pi[:, 1]
    ci, si = torch.cos(pi[:, 2]), torch.sin(pi[:, 2])
    tx = ci * dx + si * dy
    ty = -si * dx + ci * dy
    cm, sm = torch.cos(meas[:, 2]), torch.sin(meas[:, 2])
    ex = cm * (tx - meas[:, 0]) + sm * (ty - meas[:, 1])
    ey = -sm * (tx - meas[:, 0]) + cm * (ty - meas[:, 1])
    eth = normalize_angle(pj[:, 2] - pi[:, 2] - meas[:, 2])
    err = torch.stack([ex, ey, eth], 1)
    if not with_jac:
        return err, None, None
    # A = R(-th_m) R(-th_i)
    a00 = cm * ci - sm * si
    a01 = cm * si + sm * ci
    a10 = -(sm * ci + cm * si)
    a11 = -sm * si + cm * ci
    # the th_i column: R(-th_m) @ [ty, -tx]
    gx = cm * ty + sm * (-tx)
    gy = -sm * ty + cm * (-tx)
    z = torch.zeros_like(ex)
    one = torch.ones_like(ex)
    Ji = torch.stack([torch.stack([-a00, -a01, gx], 1),
                      torch.stack([-a10, -a11, gy], 1),
                      torch.stack([z, z, -one], 1)], 1)
    Jj = torch.stack([torch.stack([a00, a01, z], 1),
                      torch.stack([a10, a11, z], 1),
                      torch.stack([z, z, one], 1)], 1)
    return err, Ji, Jj


def _xy_jac(n, like):
    J = like.new_zeros((n, 2, 3))
    J[:, 0, 0] = 1.0
    J[:, 1, 1] = 1.0
    return J


def _yaw_jac(n, like):
    J = like.new_zeros((n, 1, 3))
    J[:, 0, 2] = 1.0
    return J


def _families(graph: SE2Graph, state, level, with_jac, se2_rows=slice(None)):
    """(i, j, r, Ji, Jj, info, active, kernel, delta, dim) per edge family;
    ``se2_rows`` restricts the se2 table (chain_lm takes its tail)."""
    e = graph.edges
    ei, ej = e.i[se2_rows], e.j[se2_rows]
    r, Ji, Jj = _se2_edge_err_jac(state[ei], state[ej], e.meas[se2_rows], with_jac)
    yield (ei, ej, r, Ji, Jj, e.info[se2_rows],
           e.mask[se2_rows] & (e.level[se2_rows] == level),
           e.kernel[se2_rows], e.delta[se2_rows], 3)

    p = graph.priors_xy
    n = p.i.shape[0]
    yield (p.i, p.i, state[p.i, :2] - p.meas,
           _xy_jac(n, state) if with_jac else None, None, p.info,
           p.mask & (p.level == level), p.kernel, p.delta, 2)

    q = graph.priors_yaw
    n = q.i.shape[0]
    yield (q.i, q.i, normalize_angle(state[q.i, 2] - q.meas)[:, None],
           _yaw_jac(n, state) if with_jac else None, None,
           q.info.reshape(-1, 1, 1), q.mask & (q.level == level),
           q.kernel, q.delta, 1)


def _e2(r, info, dim):
    rr = r.reshape(r.shape[0], dim)
    return torch.einsum("ea,eab,eb->e", rr, info.reshape(-1, dim, dim), rr)


def _chi2(graph: SE2Graph, state, level):
    total = state.new_zeros(())
    nact = torch.zeros((), dtype=torch.int64, device=state.device)
    for _, _, r, _, _, info, act, kern, delta, dim in _families(
            graph, state, level, with_jac=False):
        rho = robust_rho(_e2(r, info, dim), kern, delta)
        total = total + torch.where(act, rho, torch.zeros_like(rho)).sum()
        nact = nact + act.sum()
    return total, nact


def _linearize(graph: SE2Graph, state, level, se2_rows=slice(None)):
    parts = []
    chi2 = state.new_zeros(())
    for i, j, r, Ji, Jj, info, act, kern, delta, dim in _families(
            graph, state, level, with_jac=True, se2_rows=se2_rows):
        e2 = _e2(r, info, dim)
        rho = robust_rho(e2, kern, delta)
        w = torch.where(act, robust_weight(e2, kern, delta), torch.zeros_like(e2))
        chi2 = chi2 + torch.where(act, rho, torch.zeros_like(rho)).sum()
        Wf = info.reshape(-1, dim, dim) * w[:, None, None]
        parts.append((i, j) + pad_block(r, Ji, Jj, Wf, dim, 3))
    return concat_sys(parts), chi2


def _free_mask(graph: SE2Graph, level):
    """(V,3) float64: vertices touched by an active edge, allocated and not
    fixed."""
    V = graph.poses.shape[0]
    cnt = torch.zeros(V, dtype=torch.int64, device=graph.poses.device)
    e, p, q = graph.edges, graph.priors_xy, graph.priors_yaw
    m = (e.mask & (e.level == level)).to(torch.int64)
    for idx, act in ((e.i, m), (e.j, m),
                     (p.i, (p.mask & (p.level == level)).to(torch.int64)),
                     (q.i, (q.mask & (q.level == level)).to(torch.int64))):
        cnt.index_put_((idx,), act, accumulate=True)
    free = (cnt > 0) & ~graph.fixed & graph.vmask
    return free.to(torch.float64)[:, None].expand(V, 3).contiguous()


def _apply_update(state, dx):
    """Additive update with theta wrapped by an integer multiple of 2*pi
    (round half to even), as the JAX package's double-float state."""
    out = state + dx
    th = out[:, 2]
    out[:, 2] = th - torch.round(th / _TWO_PI) * _TWO_PI
    return out


def _n_edges_total(graph: SE2Graph):
    return (graph.edges.mask.sum() + graph.priors_xy.mask.sum()
            + graph.priors_yaw.mask.sum())


def _graph_f64(graph: SE2Graph) -> SE2Graph:
    """The graph with float64 poses and edge values (the solver's state)."""
    return SE2Graph(graph.poses.to(torch.float64), graph.fixed, graph.vmask,
                    *(t._replace(**{k: getattr(t, k).to(torch.float64)
                                    for k in ("meas", "info", "delta")})
                      for t in (graph.edges, graph.priors_xy, graph.priors_yaw)))


def _optimize(graph: SE2Graph, level, cfg: SolverConfig):
    graph = _graph_f64(graph)
    free = _free_mask(graph, level)
    if (cfg.backend == "chain" and cfg.chain_layout > 0
            and cfg.chain_precision == "df" and cfg.chain_refine_steps == 0):
        from .chain_lm import lm_se2_chain

        return lm_se2_chain(graph, level, free, cfg, _n_edges_total(graph))
    return lm_optimize(
        lambda s: _linearize(graph, s, level), lambda s: _chi2(graph, s, level),
        _apply_update, graph.poses, free, cfg,
        n_edges_total=_n_edges_total(graph),
    )


# segment count of the automatic locality-aware SPIKE solve, and its limits
# (the JAX package's graph/solver.py): below SPIKE_AUTO_MIN_N vertices the
# whole-chain BCR is already cheap; above SPIKE_AUTO_MAX_LC endpoint slots a
# segment the local sweep is wider than the problem is sparse, and the
# global Woodbury of the whole-chain solve stays
SPIKE_AUTO_P = 16
SPIKE_AUTO_MIN_N = 2048
SPIKE_AUTO_MAX_LC = 128


def optimize_se2(graph: SE2Graph, level=0, config: SolverConfig = None,
                 off_hint=None, n_chain=0, local_hint=None):
    """Optimize the graph at the given level; returns (poses, SolverStats).

    Mirrors GraphSLAM::optimize(num_iterations, level)
    (graph_slam.cpp:338-352), including the < min_edges skip.

    off_hint: host-known count of off-chain edges (loop closures) for the
    chain backend; the Woodbury capacity is bucketed to the next size in
    {8, 12, 16, 24, 32, ...} >= the hint, so graphs with more off-chain
    edges than the configured capacity get a bigger one instead of
    dropping couplings (SolverStats.n_offchain_dropped reports overflow).

    n_chain: pass graph.poses.shape[0] - 1 when the graph was packed with
    to_arrays(chain_first=True); the chain backend then assembles the block
    tridiagonal and gradient by shifts.

    local_hint: host-known largest per-segment endpoint-slot need
    (SE2GraphBuilder.spike_local_need(N, level, p=SPIKE_AUTO_P)). Given it,
    an off_hint, the chain backend and no explicit chain_segments, a graph
    of at least SPIKE_AUTO_MIN_N vertices is solved by the locality-aware
    SPIKE solve (parallel/spike.py) with SPIKE_AUTO_P segments and the slot
    capacity bucketed to the hint (powers of two from 8, at most
    SPIKE_AUTO_MAX_LC), as the JAX package routes it. An explicit
    ``chain_segments > 1`` takes the segmented solve at any size.
    """
    config = config or SolverConfig()
    if n_chain and config.backend == "chain" and n_chain != config.chain_layout:
        config = dataclasses.replace(config, chain_layout=n_chain)
    if off_hint is not None and config.backend == "chain":
        k = 8
        while k < off_hint:
            if (k // 2) * 3 >= off_hint:
                k = (k // 2) * 3
                break
            k *= 2
        if k != config.chain_offrank_capacity:
            config = dataclasses.replace(config, chain_offrank_capacity=k)
    if (local_hint is not None and config.backend == "chain"
            and config.chain_segments == 0 and off_hint
            and graph.poses.shape[0] >= SPIKE_AUTO_MIN_N):
        lc = 8
        while lc < local_hint:
            lc *= 2
        if lc <= SPIKE_AUTO_MAX_LC:
            config = dataclasses.replace(config, chain_segments=SPIKE_AUTO_P,
                                         chain_local_cols=lc)
    with deterministic():
        poses, stats = _optimize(graph, int(level), config)
    return poses.to(graph.poses.dtype), stats
