"""Fused SE2 chain LM: closed-form assembly, lambda-free carry.

The delta backend's solve (solver.optimize_se2 with the chain backend, the
chain-first layout and no refinement). Against the generic loop
(lm_core.lm_optimize + chain_solve) it

- computes the chain rows' tridiagonal Hessian blocks in closed form from
  the SE2 edge structure (the 2x2 Jacobian block is a rotation, so
  J^T W J collapses to a few dozen products per edge);
- lays them by shifts and carries the lambda-free tridiagonal across
  iterations: a rejected step factors again with the new damping but never
  re-linearizes or re-assembles;
- classifies and compacts the off-chain rows once, before the loop (the
  off-chain SET is fixed for a graph and level; only its robust weights
  change);
- runs one joint BCR apply per iteration over [gradient | C^T]
  (chain_solve.chain_core_solve), or, with ``chain_segments > 1``, the
  segmented SPIKE solve of parallel/spike.py (``spike_local_solve`` when
  ``chain_local_cols > 0`` and off-chain edges exist, else
  ``spike_core_solve``);
- assembles the Hessian only on accepted steps.

Semantics of lm_core.lm_optimize (g2o Levenberg schedule, level masking,
fixed vertices, robust IRLS weights, min_edges whole-graph skip) with one
difference kept from the JAX package: the dx stop test applies to accepted
steps only.
"""

from typing import NamedTuple

import torch

from ..geom.se2 import normalize_angle
from ..ops.segment import segment_sum
from ..parallel.spike import spike_core_solve, spike_local_dropped, spike_local_solve
from .chain_solve import _scatter_tridiag, chain_core_solve, finish_tridiag, shift_chain
from .lm_core import LinSys, SolverConfig, SolverStats, bmv
from .robust import robust_rho, robust_weight
from .solver import _apply_update, _linearize


class _Bundle(NamedTuple):
    """One linearization: lambda-free tridiagonal + gradient + tail."""

    A0: torch.Tensor    # (N,3,3) raw Hessian diagonal blocks (no mask, no lam)
    B0: torch.Tensor    # (N,3,3) raw sub-diagonal blocks (B0[0] = 0)
    b: torch.Tensor     # (N,3) gradient sum J^T W r
    chi2: torch.Tensor
    tail: LinSys        # non-chain rows (loops, priors, de-overlap, ...)


class _ChainResid(NamedTuple):
    """Chain-row residual intermediates: all that the Hessian/gradient
    assembly needs, so a rejected step can skip the assembly."""

    ex: torch.Tensor
    ey: torch.Tensor
    eth: torch.Tensor
    c: torch.Tensor
    s: torch.Tensor
    gx: torch.Tensor
    gy: torch.Tensor
    wgt: torch.Tensor
    rev: torch.Tensor
    chi2: torch.Tensor


def _chain_resid(graph, state, level, nc) -> _ChainResid:
    """Residual/chi2/robust-weight pass over the chain rows. Row k holds
    the odometry edge between vertices {k, k+1} in either orientation;
    inactive slots are zero-weighted no-ops."""
    e = graph.edges
    rev = e.i[:nc] > e.j[:nc]
    rv = rev[:, None]
    pi = torch.where(rv, state[1:nc + 1], state[:nc])
    pj = torch.where(rv, state[:nc], state[1:nc + 1])
    meas = e.meas[:nc]
    dx = pj[:, 0] - pi[:, 0]
    dy = pj[:, 1] - pi[:, 1]
    ci, si = torch.cos(pi[:, 2]), torch.sin(pi[:, 2])
    tx = ci * dx + si * dy
    ty = -si * dx + ci * dy
    cm, sm = torch.cos(meas[:, 2]), torch.sin(meas[:, 2])
    ex = cm * (tx - meas[:, 0]) + sm * (ty - meas[:, 1])
    ey = -sm * (tx - meas[:, 0]) + cm * (ty - meas[:, 1])
    eth = normalize_angle(pj[:, 2] - pi[:, 2] - meas[:, 2])

    # Ji = [[-c,-s,gx],[s,-c,gy],[0,0,-1]], Jj = [[c,s,0],[-s,c,0],[0,0,1]]
    # with Rot = [[c,s],[-s,c]] = R(-th_m) R(-th_i)
    c = cm * ci - sm * si
    s = cm * si + sm * ci
    gx = cm * ty - sm * tx
    gy = -(sm * ty + cm * tx)

    info = e.info[:nc]
    i00, i01, i02 = info[:, 0, 0], info[:, 0, 1], info[:, 0, 2]
    i11, i12, i22 = info[:, 1, 1], info[:, 1, 2], info[:, 2, 2]
    e2 = (ex * (i00 * ex + i01 * ey + i02 * eth)
          + ey * (i01 * ex + i11 * ey + i12 * eth)
          + eth * (i02 * ex + i12 * ey + i22 * eth))
    kern, delta = e.kernel[:nc], e.delta[:nc]
    act = e.mask[:nc] & (e.level[:nc] == level)
    zero = torch.zeros_like(e2)
    chi2 = torch.where(act, robust_rho(e2, kern, delta), zero).sum()
    wgt = torch.where(act, robust_weight(e2, kern, delta), zero)
    return _ChainResid(ex, ey, eth, c, s, gx, gy, wgt, rev, chi2)


def _chain_pass(graph, cr: _ChainResid, nc):
    """Closed-form chain-row blocks (Hii, Hjj, Hij) in the STORED (i, j)
    orientation and the gradient halves (bi, bj)."""
    info = graph.edges.info[:nc]
    c, s, gx, gy, wgt = cr.c, cr.s, cr.gx, cr.gy, cr.wgt
    w11, w12, w13 = wgt * info[:, 0, 0], wgt * info[:, 0, 1], wgt * info[:, 0, 2]
    w22, w23, w33 = wgt * info[:, 1, 1], wgt * info[:, 1, 2], wgt * info[:, 2, 2]

    # With q = W2 g - w23vec:
    #   Hii = [[ B2, -t],[-t^T, g'W2g - 2 g.w23 + w33]]   t = Rot^T q
    #   Hjj = [[ B2,  v],[ v^T, w33]]                      v = Rot^T w23vec
    #   Hij = [[-B2, -v],[ t^T, g.w23 - w33]]
    # where B2 = Rot^T W2 Rot, the congruence of a 2x2 by a rotation.
    m00, m01 = c * w11 - s * w12, c * w12 - s * w22
    m10, m11 = s * w11 + c * w12, s * w12 + c * w22
    b00, b01 = m00 * c - m01 * s, m00 * s + m01 * c
    b10, b11 = m10 * c - m11 * s, m10 * s + m11 * c
    v0, v1 = c * w13 - s * w23, s * w13 + c * w23
    wg0, wg1 = w11 * gx + w12 * gy, w12 * gx + w22 * gy
    q0, q1 = wg0 - w13, wg1 - w23
    t0, t1 = c * q0 - s * q1, s * q0 + c * q1
    gw23 = gx * w13 + gy * w23
    hgg = (gx * wg0 + gy * wg1) - 2.0 * gw23 + w33
    hij22 = gw23 - w33

    def blk(r0, r1, r2):
        return torch.stack([torch.stack(r0, -1), torch.stack(r1, -1),
                            torch.stack(r2, -1)], -2)

    Hii = blk([b00, b01, -t0], [b10, b11, -t1], [-t0, -t1, hgg])
    Hjj = blk([b00, b01, v0], [b10, b11, v1], [v0, v1, w33])
    Hij = blk([-b00, -b01, -v0], [-b10, -b11, -v1], [t0, t1, hij22])

    Wr0 = w11 * cr.ex + w12 * cr.ey + w13 * cr.eth
    Wr1 = w12 * cr.ex + w22 * cr.ey + w23 * cr.eth
    Wr2 = w13 * cr.ex + w23 * cr.ey + w33 * cr.eth
    bj0 = c * Wr0 - s * Wr1
    bj1 = s * Wr0 + c * Wr1
    bi = torch.stack([-bj0, -bj1, gx * Wr0 + gy * Wr1 - Wr2], -1)
    bj = torch.stack([bj0, bj1, Wr2], -1)
    return Hii, Hjj, Hij, bi, bj


def _residual_pass(graph, state, level, nc):
    """Trial evaluation: chain residual intermediates + the full tail
    linearization (a few dozen live rows) + total chi2. Enough for LM's
    accept/reject; on accept the intermediates feed _assemble_bundle."""
    cr = _chain_resid(graph, state, level, nc)
    tail, chi2_t = _linearize(graph, state, level, se2_rows=slice(nc, None))
    return cr, tail, cr.chi2 + chi2_t


def _tail_off(tail: LinSys, free_v):
    """Off-chain tail rows: they go through the Woodbury correction."""
    active = (tail.W != 0).any(dim=2).any(dim=1)
    return (((tail.i - tail.j).abs() > 1) & free_v[tail.i] & free_v[tail.j]
            & active)


def _assemble_bundle(graph, cr, tail, chi2_total, nc, N, free_v):
    """Hessian/gradient assembly from a _residual_pass result (run on
    accepted steps only). free_v: (N,) bool, vertices free at this level."""
    Hii, Hjj, Hij, bi, bj = _chain_pass(graph, cr, nc)
    rv = cr.rev[:, None, None]
    A0, B0 = shift_chain(torch.where(rv, Hjj, Hii), torch.where(rv, Hii, Hjj),
                         torch.where(rv, Hij, Hij.transpose(1, 2)), N)

    # chainlike tail rows (fixed-endpoint edges, |i-j| <= 1 duplicates,
    # priors) fold into the tridiagonal; off-chain ones are left out
    t_off = _tail_off(tail, free_v)
    JiT, JjT = tail.Ji.transpose(1, 2), tail.Jj.transpose(1, 2)
    WJj = tail.W @ tail.Jj
    At, Bt = _scatter_tridiag(JiT @ tail.W @ tail.Ji, JjT @ WJj, JiT @ WJj,
                              tail.i, tail.j, ~t_off, N)

    rv1 = cr.rev[:, None]
    b = bi.new_zeros((N, 3))
    b[:nc] += torch.where(rv1, bj, bi)
    b[1:nc + 1] += torch.where(rv1, bi, bj)
    Wr = bmv(tail.W, tail.r)
    b = b + segment_sum(bmv(JiT, Wr), tail.i, N) + segment_sum(bmv(JjT, Wr), tail.j, N)
    return _Bundle(A0 + At, B0 + Bt, b, chi2_total, tail), t_off


def lm_se2_chain(graph, level, free, cfg: SolverConfig, n_edges_total):
    """lm_optimize for SE2 chain-first graphs, backend 'chain', precision
    'df' (float64), no refinement. ``graph`` holds float64 tables.
    Returns (float64 poses, SolverStats)."""
    nc = cfg.chain_layout
    N = free.shape[0]
    state = graph.poses
    free_v = (free > 0).any(dim=1)

    cr, tail, chi2 = _residual_pass(graph, state, level, nc)
    bundle, t_off0 = _assemble_bundle(graph, cr, tail, chi2, nc, N, free_v)
    skip = n_edges_total < cfg.min_edges

    # the off-chain set, compacted once: first K_cap in table order
    K_cap = min(int(cfg.chain_offrank_capacity), tail.i.shape[0])
    order = torch.argsort((~t_off0).to(torch.int32), stable=True)[:K_cap]
    live = t_off0[order]
    gate = live[:, None, None].to(free.dtype)
    off_i, off_j = tail.i[order], tail.j[order]
    n_drop = t_off0.sum() - live.sum()
    segments = cfg.chain_segments > 1
    local = segments and cfg.chain_local_cols > 0 and K_cap > 0
    if local:
        # the locality-aware segmented solve also drops edges whose
        # endpoints overflow a segment's slots; the packing is fixed for a
        # graph and level, so it is counted once, here
        n_drop = n_drop + spike_local_dropped(off_i, off_j, live, N,
                                              cfg.chain_segments,
                                              cfg.chain_local_cols)

    def off_rows(b):
        return (off_i, off_j, b.tail.Ji[order] * gate, b.tail.Jj[order] * gate,
                b.tail.W[order] * gate)

    # lam0 = tau * max |diag H| over free dims (g2o Levenberg init); the
    # off-chain rows add their diagonal contributions on top of A0's
    _, _, oJi, oJj, oW = off_rows(bundle)
    dg = torch.diagonal(bundle.A0, dim1=-2, dim2=-1)
    dg = dg + segment_sum(torch.einsum("kba,kbc,kca->ka", oJi, oW, oJi), off_i, N)
    dg = dg + segment_sum(torch.einsum("kba,kbc,kca->ka", oJj, oW, oJj), off_j, N)
    lam = cfg.lm_tau * torch.clamp((torch.abs(dg) * free).max(), min=1e-12)
    nu = torch.tensor(2.0, dtype=free.dtype, device=free.device)

    def solve(b, lam):
        A, B = finish_tridiag(b.A0, b.B0, free, lam)
        off = off_rows(b) if K_cap > 0 else None
        if local:
            return spike_local_solve(A, B, -b.b, free, N, p=cfg.chain_segments,
                                     off=off, Lc=cfg.chain_local_cols,
                                     mesh_axis=cfg.chain_mesh_axis)[0]
        if segments:
            return spike_core_solve(A, B, -b.b, free, N, p=cfg.chain_segments,
                                    off=off, mesh_axis=cfg.chain_mesh_axis)
        return chain_core_solve(A, B, -b.b, free, N, off=off)

    chi2_0 = chi2 = bundle.chi2
    skipped, lam_ok = torch.stack([skip, lam < 1e12]).tolist()
    go = not skipped and lam_ok
    it = 0
    while go and it < cfg.max_iterations:
        dx = solve(bundle, lam)
        trial = _apply_update(state, dx)
        # cheap trial evaluation; the Hessian assembly runs below only if
        # the step is accepted (a rejected Levenberg trial re-solves with
        # bigger lambda and never needs the trial's Hessian)
        cr_t, tail_t, chi2_t = _residual_pass(graph, trial, level, nc)
        denom = (dx * (lam * dx - bundle.b)).sum()
        rho = (chi2 - chi2_t) / torch.where(torch.abs(denom) < 1e-30,
                                            torch.full_like(denom, 1e-30), denom)
        accept = (chi2_t < chi2) & torch.isfinite(trial).all()
        chi2_n = torch.where(accept, chi2_t, chi2)
        lam_dec = lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam = torch.where(accept, lam_dec, lam * nu)
        nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        converged = accept & (
            ((chi2 - chi2_n) <= cfg.chi2_rel_tol * torch.clamp(chi2, min=1e-30))
            | ((dx * dx).sum() < cfg.dx_tol))
        chi2 = chi2_n
        it += 1
        took, go = torch.stack([accept, ~converged & (lam < 1e12)]).tolist()
        if took:
            state = trial
            bundle = _assemble_bundle(graph, cr_t, tail_t, chi2_t, nc, N, free_v)[0]

    e, p, q = graph.edges, graph.priors_xy, graph.priors_yaw
    nact = ((e.mask & (e.level == level)).sum() + (p.mask & (p.level == level)).sum()
            + (q.mask & (q.level == level)).sum())
    return state, SolverStats(
        chi2_initial=chi2_0, chi2_final=chi2, iterations=-1 if skipped else it,
        lambda_final=lam, num_active_edges=nact, n_offchain_dropped=n_drop,
    )
