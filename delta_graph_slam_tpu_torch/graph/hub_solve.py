"""Direct SE3 pose-graph solve: chain BCR + hub-vertex elimination.

The hdl/SE3 graph (models/hdl_backend.py) is an odometry chain of pose
vertices plus a handful of HUB vertices (floor planes, point landmarks)
that every keyframe may share an edge with: the reference wires one
EdgeSE3Plane per keyframe to a single g2o plane vertex. Edge-based Woodbury
(chain_solve.py) cannot absorb that: the hub collects one off-chain edge
per keyframe, so K grows with the trajectory.

So the hub VERTICES are eliminated first. With the unified vertex space
ordered [poses 0..Vc-1 | hubs Vc..N-1], the damped Hessian is a bordered
block arrow

    H = [[T,    Bc  ],      T   chain tridiagonal + pose-unary diagonals
         [Bc^T, A_hh]]      Bc  (Vc*D, nh*D) coupling, A_hh hub block

A_hh is tiny (nh*D square) and well conditioned (thousands of edge
informations + lam on its diagonal), so x_h = A_hh^{-1}(b_h - Bc^T x_c) is
exact, and the reduced system

    (T + C^T W C - Bc A_hh^{-1} Bc^T) x_c = b_c - Bc A_hh^{-1} b_h

has the chain + low-rank shape the SE2 solver already handles: the hub
coupling is nh*D more Woodbury columns with block weight -A_hh^{-1}, joined
with the off-chain loop edges in ONE generalized capacitance

    x_c = u - V (I + Wt U V)^{-1} Wt U u,
    U = [C; Bc^T],  Wt = blockdiag(W_edges, -A_hh^{-1}),  V = T^{-1} U^T.

Everything runs in native float64, for the kappa ~ N^2 reason given in
chain_solve.py; the JAX package runs the same algebra in double-float with
a refined float32 capacitance solve, which one float64 solve replaces here.
Every float scatter-add is a ``segment_sum``: the caller holds
``deterministic()`` around the solve, as optimize_se3 does.

Replaces g2o lm_var_cholmod for the SE3/hdl capability set
(graph_slam.cpp:31-76, 338-352).
"""

import torch

from ..ops.segment import segment_sum
from .chain_solve import (
    _T, _coupling_rhs, _edge_hessians, _offchain_compact, _pad_to, bcr_apply,
    bcr_factor, finish_tridiag,
)
from .lm_core import LinSys, bmv


def _gate(X, g):
    return X * g[:, None, None].to(X.dtype)


def _spread(ids, live, n):
    """Slot ids for a sorted scatter-add whose dead rows (value 0) would all
    share one id: the sort-based kernel walks each run of equal ids with one
    warp, so thousands of padded rows on slot 0 serialize. Dead rows go to
    slot (row mod n) instead, where adding their zeros changes nothing."""
    rows = torch.arange(ids.shape[0], device=ids.device)
    return torch.where(live, ids, rows % n)


def _slot_sum(vals, ids, n):
    """segment_sum into a handful of slots (the hubs), as one product with
    the slots' indicator matrix: every run is long there, and a product adds
    them in a fixed order at full speed."""
    onehot = (ids[None, :] == torch.arange(n, device=ids.device)[:, None]).to(vals.dtype)
    return (onehot @ vals.reshape(vals.shape[0], -1)).reshape((n,) + tuple(vals.shape[1:]))


def _hub_classify(sys: LinSys, free, Vc):
    """Edge routing masks over the unified [poses | hubs] index space."""
    active = (sys.W != 0).any(dim=2).any(dim=1)
    free_v = (free > 0).any(dim=1)
    hub_i = sys.i >= Vc
    hub_j = sys.j >= Vc
    pp = ~hub_i & ~hub_j
    off = (pp & ((sys.i - sys.j).abs() > 1)
           & free_v[sys.i] & free_v[sys.j] & active)
    chain = pp & ~off
    xor = hub_i ^ hub_j
    # coupling edges that really produce a nonzero Bc block (both endpoints
    # free, edge active); a coupling with a fixed endpoint is a pure
    # diagonal contribution and must not take a capacity slot
    coup = xor & active & free_v[sys.i] & free_v[sys.j]
    hh = hub_i & hub_j
    return chain, off, xor, coup, hh, hub_i, hub_j, active


def hub_overflow(sys: LinSys, free, N, n_hub, K_cap, coup_cap):
    """Active off-chain + coupling edges beyond their capacities (int64)."""
    _, off, _, coup, _, _, _, _ = _hub_classify(sys, free, N - n_hub)
    k_eff = min(int(K_cap), sys.i.shape[0])
    c_eff = min(int(coup_cap), sys.i.shape[0])
    return (torch.clamp(off.sum() - k_eff, min=0)
            + torch.clamp(coup.sum() - c_eff, min=0))


def _assemble_chain(Hii, Hjj, Hij, sys, Vc, free_c, lam, chain, xor, hub_i,
                    hub_j, active):
    """Chain tridiagonal over pose rows [0..Vc-1].

    A diagonal block takes every edge endpoint that lives on a pose and is
    not in the Woodbury off set: chain edges give both ends, coupling edges
    their pose end (the hub end goes to A_hh)."""
    g_i = chain | (xor & ~hub_i)
    g_j = chain | (xor & ~hub_j)
    ii = torch.clamp(sys.i, 0, Vc - 1)
    jj = torch.clamp(sys.j, 0, Vc - 1)
    live = torch.cat([g_i & active, g_j & active])   # the other rows add 0
    A = segment_sum(torch.cat([_gate(Hii, g_i), _gate(Hjj, g_j)]),
                    _spread(torch.cat([ii, jj]), live, Vc), Vc)
    sub_ok = chain & ((sys.i - sys.j).abs() == 1)
    val = _gate(torch.where((sys.j > sys.i)[:, None, None], _T(Hij), Hij), sub_ok)
    B = segment_sum(val, _spread(torch.clamp(torch.maximum(sys.i, sys.j), 0, Vc - 1),
                                 sub_ok & active, Vc), Vc)
    return finish_tridiag(A, B, free_c, lam)


def _assemble_hub(Hii, Hjj, Hij, sys, Vc, nh, free_h, lam, xor, hh, hub_i,
                  hub_j):
    """Dense hub block A_hh (nh*D square), fixed dims -> identity."""
    D = Hii.shape[-1]
    il = torch.clamp(sys.i - Vc, 0, nh - 1)
    jl = torch.clamp(sys.j - Vc, 0, nh - 1)
    g_di = (xor | hh) & hub_i
    g_dj = (xor | hh) & hub_j & (sys.i != sys.j)   # unary hub edges: i == j
    g_off = hh & (sys.i != sys.j)
    vals = torch.cat([_gate(Hii, g_di), _gate(Hjj, g_dj),
                      _gate(Hij, g_off), _gate(_T(Hij), g_off)])
    ids = torch.cat([il * nh + il, jl * nh + jl, il * nh + jl, jl * nh + il])
    S = _slot_sum(vals, ids, nh * nh)                # (nh*nh, D, D)
    A = S.reshape(nh, nh, D, D).permute(0, 2, 1, 3).reshape(nh * D, nh * D)
    eye = torch.eye(nh * D, dtype=A.dtype, device=A.device)
    fm = free_h[:, None] * free_h[None, :]
    return A * fm + (1.0 - fm) * eye + lam * torch.diag(free_h)


def _coupling_compact(Hij, sys, coup, Vc, nh, Ec_cap, free):
    """The first Ec_cap coupling edges as (pose idx, hub local, Me, live)
    with Me the free-masked (pose rows x hub cols) block, dead slots zero;
    plus the overflow count."""
    Ec_cap = min(int(Ec_cap), sys.i.shape[0])
    order = torch.argsort((~coup).to(torch.int32), stable=True)[:Ec_cap]
    live = coup[order]
    i, j = sys.i[order], sys.j[order]
    hub_is_i = i >= Vc      # an edge may be stored hub-first
    p = torch.clamp(torch.where(hub_is_i, j, i), 0, Vc - 1)
    h = torch.clamp(torch.where(hub_is_i, i, j) - Vc, 0, nh - 1)
    Ho = Hij[order]
    Me = torch.where(hub_is_i[:, None, None], _T(Ho), Ho)
    free_h = free[Vc:]                                      # (nh, D)
    Me = Me * (live[:, None, None].to(free.dtype)
               * free[p][:, :, None] * free_h[h][:, None, :])
    return p, h, Me, live, coup.sum() - live.sum()


def chain_hub_solve(sys: LinSys, b, free, lam, N, n_hub, K_cap=32,
                    coup_cap=4096):
    """Direct float64 solve of (H + lam I) x = b on a chain + hub graph.

    Vertex layout: [poses 0..N-n_hub-1 | hubs]. Returns (x (N,D),
    n_dropped), n_dropped counting active off-chain loop edges beyond K_cap
    plus coupling edges beyond coup_cap (the caller should solve again with
    bigger capacities: the contract of chain_solve).
    """
    out_dtype = b.dtype
    dt = torch.float64
    sys = LinSys(sys.i, sys.j, *(t.to(dt) for t in sys[2:]))
    b, free, lam = b.to(dt), free.to(dt), torch.as_tensor(lam).to(dt)
    D = b.shape[1]
    Vc = N - n_hub
    nh = n_hub
    Hd = nh * D
    K = min(int(K_cap), sys.i.shape[0])

    chain, off, xor, coup, hh, hub_i, hub_j, active = _hub_classify(sys, free, Vc)
    Hii, Hjj, Hij = _edge_hessians(sys)

    free_c = free[:Vc]
    free_h = free[Vc:].reshape(Hd)
    A, B = _assemble_chain(Hii, Hjj, Hij, sys, Vc, free_c, lam, chain, xor,
                           hub_i, hub_j, active)
    Ahh = _assemble_hub(Hii, Hjj, Hij, sys, Vc, nh, free_h, lam, xor, hh,
                        hub_i, hub_j)
    Ahh_inv = torch.linalg.inv_ex(Ahh).inverse

    pc, hc, Me, live_c, n_drop_c = _coupling_compact(Hij, sys, coup, Vc, nh,
                                                     coup_cap, free)
    MeT = _T(Me)
    # dense coupling Bc (Vc, D, Hd) FROM the compacted set, so the Woodbury
    # columns and the elimination see the same operator even when coup_cap
    # overflows (dropped edges vanish from both)
    Bc = segment_sum(Me, _spread(pc * nh + hc, live_c, Vc * nh), Vc * nh)
    Bc = Bc.reshape(Vc, nh, D, D).permute(0, 2, 1, 3).reshape(Vc, D, Hd)

    def hub_rows(X):
        """Bc^T X for X (Vc, D, R): (Hd, R), from the compacted edges."""
        return _slot_sum(MeT @ X[pc], hc, nh).reshape(Hd, X.shape[-1])

    bc = b[:Vc] * free_c
    bh = (b[Vc:] * free[Vc:]).reshape(Hd)
    # reduced right-hand side: b_c - Bc A_hh^{-1} b_h
    b_red = bc - (Bc.reshape(Vc * D, Hd) @ (Ahh_inv @ bh)).reshape(Vc, D)

    # off-chain loop edges -> Woodbury slots (pose-space indices; a dead
    # slot may hold any row of the table, so its indices are clamped)
    ei, ej, Ji, Jj, W, n_drop_k = _offchain_compact(sys, off, K)
    ei = torch.clamp(ei, 0, Vc - 1)
    ej = torch.clamp(ej, 0, Vc - 1)
    Ct = _coupling_rhs(ei, ej, Ji, Jj, free_c, Vc)         # (Vc, D, K*D)

    # ONE joint BCR sweep over [b_red | C^T | Bc]
    P = 1 << max(int(Vc - 1).bit_length(), 2)
    factors = bcr_factor(_pad_to(A, P, fill_eye=True), _pad_to(B, P))
    G = torch.cat([b_red[:, :, None], Ct, Bc], dim=-1)     # (Vc, D, R)
    sol = bcr_apply(factors, _pad_to(G, P))[:Vc]
    u = sol[:, :, 0]                                       # (Vc, D)
    Vt = sol[:, :, 1:]                                     # (Vc, D, R-1)
    R1 = Vt.shape[-1]

    # generalized capacitance Mcap = I + Wt U V over [loops | hubs]
    WCV = W @ (Ji @ Vt[ei] + Jj @ Vt[ej])                  # (K, D, R-1)
    rows = torch.cat([WCV.reshape(K * D, R1), -(Ahh_inv @ hub_rows(Vt))])
    Mcap = torch.eye(R1, dtype=dt, device=b.device) + rows
    # rhs_cap = Wt U u
    WCu = bmv(W, bmv(Ji, u[ei]) + bmv(Jj, u[ej])).reshape(K * D)
    rhs = torch.cat([WCu, -(Ahh_inv @ hub_rows(u[:, :, None])[:, 0])])
    y = torch.linalg.solve_ex(Mcap, rhs).result

    xc = u - (Vt.reshape(Vc * D, R1) @ y).reshape(Vc, D)
    # back-substitute the hubs: x_h = A_hh^{-1} (b_h - Bc^T x_c)
    xh = Ahh_inv @ (bh - hub_rows(xc[:, :, None])[:, 0])
    x = torch.cat([xc, xh.reshape(nh, D)]) * free
    return x.to(out_dtype), n_drop_k + n_drop_c
