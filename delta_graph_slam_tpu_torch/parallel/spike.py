"""Segmented direct pose-graph solve: SPIKE substructuring of the chain.

Counterpart of the JAX package's parallel/spike.py. The chain solve of
graph/chain_solve.py eliminates the whole odometry chain with one block
cyclic reduction, whose log2(N) levels run one after the other. This module
splits the chain into p contiguous segments instead (SPIKE / Wang's
partition method):

    T = D + U Wr U^T
    D  = blockdiag(T_1 .. T_p)   (p contiguous segments of the chain)
    U  = indicator columns at the 2(p-1) interface rows   (exact 0/1)
    Wr = blockdiag over interfaces of [[0, B^T], [B, 0]]

Every segment T_s is factored by the same BCR; the p segments are a batch
dimension of one factorization (bcr_factor with a leading p), so the
launches of a level serve all segments. Interfaces and off-chain edges
(loops) are absorbed by one joint Woodbury capacitance of size
(2(p-1) + K)·D:

    T^{-1} g = u - V (I + W C V)^{-1} W C u,   u, V = D^{-1} [g | U | C^T]

The algebra is that of the single chain solve; the elimination order
differs, so the two agree to float64 roundoff, not bit for bit.

Precision: the JAX package carries the blocks in double-float (two float32
limbs) because the TPU has no fast float64; here everything is native
float64 and the capacitance is solved directly (torch.linalg.solve_ex)
where the JAX package inverts it in float32 and refines twice.

``mesh_axis`` is accepted for the JAX package's signature: there it names
the device-mesh axis the segment dimension is sharded over. On one card
the segments are a batch dimension on the tensors' device, and the
argument changes nothing.

Replaces: g2o lm_var_cholmod (launch/delta_graph_slam.launch:81), through
the automatic route of graph/solver.py:optimize_se2 for large graphs.
"""

import torch

from ..graph.chain_solve import bcr_apply, bcr_factor
from ..graph.lm_core import bmv
from ..ops.segment import segment_sum


def _T(a):
    return a.transpose(-1, -2)


def _segment_len(N, p):
    """Rows a segment holds: ceil(N / p) rounded up to a power of two."""
    m = -(-N // p)
    return 1 << max(m - 1, 1).bit_length() if m & (m - 1) else m


def _pad_pow2_segments(A, B, b, free, N, p):
    """Pad to p segments of power-of-two length m (identity diagonal,
    zero coupling, zero right-hand side and free mask: exact no-ops)."""
    D = b.shape[1]
    m = _segment_len(N, p)
    P = p * m
    if P > N:
        eye = torch.eye(D, dtype=A.dtype, device=A.device)
        A = torch.cat([A, eye.expand(P - N, D, D)])
        B = torch.cat([B, B.new_zeros((P - N, D, D))])
        b = torch.cat([b, b.new_zeros((P - N, D))])
        free = torch.cat([free, free.new_zeros((P - N, D))])
    return A, B, b, free, m, P


def _segments(A, B, p, m):
    """(p, m, D, D) segment blocks, the chain cut at every segment start
    (the interface couplings move to Wr)."""
    D = A.shape[-1]
    B_seg = B.reshape(p, m, D, D).clone()
    B_seg[:, 0] = 0.0
    return A.reshape(p, m, D, D), B_seg


def _interface_weights(B_if):
    """W blocks of the 2(p-1) interface edges, [B^T, B, B^T, B, ...], and
    the pair swap: interface edge 2t applies B^T to its partner's (2t+1)
    C-row and vice versa."""
    n_if, D = 2 * B_if.shape[0], B_if.shape[-1]
    W_if = torch.stack([_T(B_if), B_if], dim=1).reshape(n_if, D, D)
    pair = torch.arange(n_if, device=B_if.device).reshape(-1, 2).flip(1).reshape(-1)
    return W_if, pair


def _capacitance_solve(WCV, WCu):
    """y = (I + W C V)^{-1} W C u; WCV (K, D, K*D), WCu (K, D)."""
    KD = WCu.numel()
    Mcap = torch.eye(KD, dtype=WCV.dtype, device=WCV.device) + WCV.reshape(KD, KD)
    return torch.linalg.solve_ex(Mcap, WCu.reshape(KD)).result


def spike_core_solve(A, B, b, free, N, p, off=None, mesh_axis=None):
    """Solve T x = b with T split into p chain segments.

    A, B: (N,D,D) float64 assembled tridiagonal (fixed-dim identities and
    damping applied, B[0] = 0). off: optional off-chain table (ei, ej, Ji,
    Jj, W) as in chain_solve.chain_core_solve. mesh_axis: see the module
    docstring. Returns x (N,D).
    """
    D = b.shape[1]
    device, dtype = b.device, b.dtype
    A, B, bp, freep, m, P = _pad_pow2_segments(A, B, b, free, N, p)

    # interface rows: a_t = t*m - 1, b_t = t*m   (t = 1..p-1)
    t_idx = torch.arange(1, p, device=device) * m
    B_if = B[t_idx]
    factors = bcr_factor(*_segments(A, B, p, m))

    # right-hand sides: [b | U (interface indicators) | C^T]
    n_if = 2 * (p - 1)
    K_l = 0 if off is None else off[0].shape[0]
    cols = [(bp * freep)[:, :, None]]
    if n_if:
        rows_if = torch.stack([t_idx - 1, t_idx], dim=1).reshape(-1)
        U = torch.zeros((P, D, n_if * D), dtype=dtype, device=device)
        ar = torch.arange(D, device=device)
        col0 = torch.arange(n_if, device=device) * D
        U.index_put_((rows_if[:, None, None], ar[None, :, None],
                      col0[:, None, None] + ar[None, None, :]),
                     torch.eye(D, dtype=dtype, device=device).expand(n_if, D, D))
        cols.append(U * freep[:, :, None])
    if K_l:
        ei, ej, Ji, Jj, W = off
        ei, ej = ei.to(torch.int64), ej.to(torch.int64)
        eyeK = torch.eye(K_l * D, dtype=dtype, device=device).reshape(K_l, D, K_l * D)
        Ct = (segment_sum(_T(Ji) @ eyeK, ei, P)
              + segment_sum(_T(Jj) @ eyeK, ej, P))
        cols.append(Ct * freep[:, :, None])
    rhs = torch.cat(cols, dim=-1)                        # (P, D, R)
    R = rhs.shape[-1]
    sol = bcr_apply(factors, rhs.reshape(p, m, D, R)).reshape(P, D, R)

    u = sol[:, :, 0]
    if n_if + K_l == 0:
        return (u * freep)[:N]
    V = sol[:, :, 1:]                                    # (P, D, K*D)
    K = n_if + K_l

    # C V rows and C u per capacitance edge: interface edge 2t (row a_t)
    # and 2t+1 (row b_t) are indicator rows; loop edge k is Ji V[ei] + Jj V[ej]
    WCV, WCu = [], []
    if n_if:
        W_if, pair = _interface_weights(B_if)
        WCV.append(W_if @ V[rows_if][pair])
        WCu.append(bmv(W_if, u[rows_if][pair]))
    if K_l:
        WCV.append(W @ (Ji @ V[ei] + Jj @ V[ej]))
        WCu.append(bmv(W, bmv(Ji, u[ei]) + bmv(Jj, u[ej])))
    y = _capacitance_solve(torch.cat(WCV), torch.cat(WCu))
    x = u - (V.reshape(P * D, K * D) @ y).reshape(P, D)
    return (x * freep)[:N]


# --------------------------------------------------------------------------
# Locality-aware variant: per-segment column packing.
#
# spike_core_solve sweeps every segment's factor over the full [b | U | C^T]
# right-hand side, 1 + (2(p-1) + K)*D columns, although a loop's C^T column
# is nonzero only inside the (at most two) segments that hold its
# endpoints. spike_local_solve packs each segment's live columns into Lc
# local slots: segment s sweeps [b | left interface | right interface | its
# own endpoint slots], 1 + (2 + Lc)*D columns. The Woodbury algebra is the
# same (one capacitance over interfaces and loop edges); only the columns
# that are zero are never formed.
# --------------------------------------------------------------------------


def _pack_endpoint_slots(ei, ej, live, m, p, Lc):
    """Assign the 2K off-chain endpoint entries to per-segment slots.

    Entry e in [0, 2K): endpoint i of edge e (e < K) or endpoint j of edge
    e - K. Returns (table (p, Lc) int64 entry or -1, edge_dropped (K,)
    bool). An edge is dropped (and must be zero-weighted by the caller)
    when EITHER endpoint overflows its segment's Lc slots: dropping one
    endpoint alone would solve an inconsistent system, dropping the whole
    edge solves the graph without that loop. Rows beyond the p segments
    count as dead entries (their slot is clamped to the dump slot).
    """
    K = ei.shape[0]
    device = ei.device
    rows = torch.cat([ei, ej]).to(torch.int64)
    live2 = torch.cat([live, live])
    seg = torch.where(live2, torch.clamp(rows // m, max=p), p)
    order = torch.argsort(seg, stable=True)
    seg_s = seg[order]
    idx = torch.arange(2 * K, device=device)
    first = torch.searchsorted(seg_s, seg_s, side="left")
    rank = idx - first
    ok = (rank < Lc) & (seg_s < p)
    slot = torch.where(ok, seg_s * Lc + rank, p * Lc)
    table = torch.full((p * Lc + 1,), -1, dtype=torch.int64, device=device)
    table[slot] = order              # ok slots are distinct; the rest dump
    table = table[: p * Lc].reshape(p, Lc)
    ent_dropped = torch.zeros((2 * K,), dtype=torch.bool, device=device)
    ent_dropped[order] = (~ok) & (seg_s < p)
    return table, ent_dropped[:K] | ent_dropped[K:]


def spike_local_dropped(ei, ej, live, N, p, Lc):
    """Edges the locality-aware solve drops for (N, p, Lc), as an int64
    tensor. The packing depends only on the off-chain SET (robust weights
    never zero an active edge), so callers count it once, outside the LM
    loop, and surface it in SolverStats.n_offchain_dropped."""
    _, edge_dropped = _pack_endpoint_slots(ei, ej, live, _segment_len(N, p), p, Lc)
    return edge_dropped.sum()


def spike_local_solve(A, B, b, free, N, p, off, Lc, mesh_axis=None):
    """Solve T x = b like spike_core_solve, sweeping only local columns.

    off = (ei, ej, Ji, Jj, W) is required (spike_core_solve or the plain
    chain solve serve graphs without off-chain edges). Lc: per-segment
    endpoint-slot capacity. Returns (x (N,D), n_edges_dropped): edges whose
    endpoints overflow Lc are left out of the correction (their W is
    zeroed), as the K_cap overflow of the chain solve.
    """
    D = b.shape[1]
    device, dtype = b.device, b.dtype
    ei, ej, Ji, Jj, W = off
    ei, ej = ei.to(torch.int64), ej.to(torch.int64)
    K = ei.shape[0]
    A, B, bp, freep, m, P = _pad_pow2_segments(A, B, b, free, N, p)

    t_idx = torch.arange(1, p, device=device) * m
    B_if = B[t_idx]
    factors = bcr_factor(*_segments(A, B, p, m))

    # ---- pack the endpoint slots ---------------------------------------
    live = (W != 0).any(dim=2).any(dim=1)
    table, edge_dropped = _pack_endpoint_slots(ei, ej, live, m, p, Lc)
    n_dropped = edge_dropped.sum()
    W_eff = W * (~edge_dropped)[:, None, None].to(dtype)

    valid = table >= 0                                   # (p, Lc)
    entry = torch.where(valid, table, 0)
    e_idx = entry % K
    side_j = entry >= K
    grow = torch.where(side_j, ej[e_idx], ei[e_idx])
    lrow = torch.where(valid, grow % m, 0)
    JT = torch.where(side_j[..., None, None], _T(Jj)[e_idx], _T(Ji)[e_idx])
    # gate: dead slots, and the free-mask rows of C^T
    JT = JT * freep[grow][..., None] * valid[..., None, None].to(dtype)

    # ---- per-segment right-hand side [b | left-if | right-if | slots] ---
    n_if = 2 * (p - 1)
    R = 1 + (2 + Lc) * D
    rhs = torch.zeros((p, m, D, R), dtype=dtype, device=device)
    rhs[..., 0] = (bp * freep).reshape(p, m, D)
    eyeD = torch.eye(D, dtype=dtype, device=device)
    segs = torch.arange(p, device=device)
    fseg = freep.reshape(p, m, D)
    left_gate = (segs >= 1).to(dtype)[:, None, None]
    right_gate = (segs <= p - 2).to(dtype)[:, None, None]
    rhs[:, 0, :, 1:1 + D] = eyeD * fseg[:, 0][:, :, None] * left_gate
    rhs[:, m - 1, :, 1 + D:1 + 2 * D] = eyeD * fseg[:, m - 1][:, :, None] * right_gate
    co = 1 + 2 * D
    ar = torch.arange(D, device=device)
    si = segs[:, None, None, None].expand(p, Lc, 1, 1)
    dcol = (co + torch.arange(Lc, device=device)[None, :, None, None] * D
            + ar[None, None, None, :])
    rhs.index_put_((si, lrow[:, :, None, None], ar[None, None, :, None], dcol), JT)

    sol = bcr_apply(factors, rhs)                        # (p, m, D, R)
    u = sol[..., 0].reshape(P, D)

    # ---- global capacitance assembly ------------------------------------
    # cap columns: [interface edges (n_if) | loop edges (K)] * D, plus one
    # dummy column block for dead slots. Local column c of segment s:
    #   c=0 left-if  of seg s = row s*m       = interface edge 2(s-1)+1
    #   c=1 right-if of seg s = row (s+1)m-1  = interface edge 2s
    #   c>=2: loop slot -> n_if + edge index
    dummy_col = n_if + K
    gcol_left = torch.where(segs >= 1, 2 * (segs - 1) + 1, dummy_col)
    gcol_right = torch.where(segs <= p - 2, 2 * segs, dummy_col)
    gcol_slots = torch.where(valid, n_if + e_idx, dummy_col)
    gcol = torch.cat([gcol_left[:, None], gcol_right[:, None], gcol_slots], dim=1)

    rows_if = torch.stack([t_idx - 1, t_idx], dim=1).reshape(-1)
    rows_needed = torch.cat([rows_if, ei, ej])
    NR = rows_needed.shape[0]
    sr = rows_needed // m
    lr = rows_needed % m
    nslots = 2 + Lc
    # (NR, nslots, D, D): row r's local V blocks, slot by slot
    Vr = sol[sr, lr, :, 1:].reshape(NR, D, nslots, D).transpose(1, 2)
    gcol_r = gcol[sr]                                    # (NR, nslots)

    # Two collision-free scatters and one add: interface columns occupy
    # [0, n_if); side-i loop columns are distinct (one side-i entry per edge
    # in the whole table), and so are side-j ones; the only same-(row,
    # column) pair is an edge with both endpoints in one segment, whose
    # i-entry (group A) and j-entry (group B) meet in the add. Dead slots
    # go to the dummy column block.
    side_full = torch.cat([torch.zeros((p, 2), dtype=torch.bool, device=device),
                           side_j], dim=1)[sr]           # (NR, nslots)
    dummy = torch.full_like(gcol_r, dummy_col)
    KD = (n_if + K) * D
    rr = torch.arange(NR, device=device)[:, None, None, None]
    dr = ar[None, None, :, None]

    def scatter(cols):
        cc = cols[:, :, None, None] * D + ar[None, None, None, :]
        out = torch.zeros((NR, D, KD + D), dtype=dtype, device=device)
        out.index_put_((rr, dr, cc), Vr)
        return out

    Vall = (scatter(torch.where(side_full, dummy, gcol_r))
            + scatter(torch.where(side_full, gcol_r, dummy)))[:, :, :KD]
    CV_if = Vall[:n_if]
    CV_l = Ji @ Vall[n_if:n_if + K] + Jj @ Vall[n_if + K:]
    u_need = u[rows_needed]
    Cu_l = bmv(Ji, u_need[n_if:n_if + K]) + bmv(Jj, u_need[n_if + K:])

    # W application (the interface pair swap of spike_core_solve)
    WCV, WCu = [], []
    if n_if:
        W_if, pair = _interface_weights(B_if)
        WCV.append(W_if @ CV_if[pair])
        WCu.append(bmv(W_if, u_need[:n_if][pair]))
    WCV.append(W_eff @ CV_l)
    WCu.append(bmv(W_eff, Cu_l))
    y = _capacitance_solve(torch.cat(WCV), torch.cat(WCu))

    # ---- correction x = u - V y over each segment's local columns --------
    ypad = torch.cat([y, y.new_zeros((D,))])
    y_loc = ypad[gcol[:, :, None] * D + ar].reshape(p, nslots * D)
    Vy = sol[..., 1:] @ y_loc[:, None, :, None]          # (p, m, D, 1)
    x = u - Vy.reshape(P, D)
    return (x * freep)[:N], n_dropped
