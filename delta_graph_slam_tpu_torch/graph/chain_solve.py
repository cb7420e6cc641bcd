"""Direct pose-graph solve: block cyclic reduction + Woodbury loops.

Replacement for CHOLMOD on SLAM graphs (the reference solves with g2o's
lm_var_cholmod, delta_graph_slam.launch:81). A pose graph's Hessian is an
odometry *chain* (block tridiagonal) plus a few off-chain edges (loop
closures, building de-overlap):

    H = T + C^T W C
    T = chain edges + unary priors + lam*I     (block tridiagonal)
    C = K off-chain binary edges, rows C_k x = Ji_k x_i + Jj_k x_j

T^{-1} is applied by block cyclic reduction (BCR): eliminate the odd block
rows level by level, each level a batch of DxD inverses and products over
half the remaining rows, so a solve is O(log N) sequential steps of
batched small-matrix work. The off-chain correction uses the binomial
inverse theorem (no W^{-1}, so padded edge slots with W = 0 are exact
no-ops):

    H^{-1} g = u - V (I + W C V_c)^{-1} W C u,
    u = T^{-1} g,  V = T^{-1} C^T  (BCR with K*D stacked right-hand sides)

Edges with a fixed endpoint only add a diagonal block, so they fold into T.

Precision. A SLAM chain's condition number grows ~ N^2, so a float32
elimination loses the whole mantissa at production sizes. The JAX package
runs this solve in double-float (two float32 limbs, ``geom/dfloat.py`` and
``graph/df_linalg.py``) because the TPU has no fast float64. The H100 has
native float64, so this port keeps no double-float code:
``SolverConfig.chain_precision`` keeps its values for config compatibility,
with ``"df"`` (the default) meaning a float64 elimination and ``"f32"`` a
float32 one. The df path of the JAX package reduces to one block and
inverts it with the adjugate; so does the float64 path here.
"""

import torch

from ..ops.segment import segment_sum
from .lm_core import LinSys, bmv, matvec


def _T(a):
    return a.transpose(-1, -2)


def _edge_hessians(sys: LinSys):
    """Per-edge blocks Hii, Hjj, Hij (robust-weighted; W = 0 for inactive
    edges makes every downstream contribution vanish)."""
    WJi = sys.W @ sys.Ji
    WJj = sys.W @ sys.Jj
    return _T(sys.Ji) @ WJi, _T(sys.Jj) @ WJj, _T(sys.Ji) @ WJj


def _classify(sys: LinSys, free_v):
    """(chainlike, off) edge masks: off = couples two free vertices more
    than one index apart; everything else folds into the tridiagonal.
    Inactive edges (W = 0: level-masked, padded, zero robust weight) never
    take a Woodbury slot."""
    active = (sys.W != 0).any(dim=2).any(dim=1)
    off = ((sys.i - sys.j).abs() > 1) & free_v[sys.i] & free_v[sys.j] & active
    return ~off, off


def offchain_overflow(sys: LinSys, free, K_cap):
    """Active off-chain edges beyond the Woodbury capacity (int64)."""
    _, off = _classify(sys, (free > 0).any(dim=1))
    k_eff = min(int(K_cap), sys.i.shape[0])
    return torch.clamp(off.sum() - k_eff, min=0)


def finish_tridiag(A, B, free, lam):
    """Fixed dims get identity rows/cols (their dx is pinned to 0), lam is
    added on free dims only, and B[0] = 0."""
    D = free.shape[1]
    eye = torch.eye(D, dtype=A.dtype, device=A.device)
    fm = free[:, :, None] * free[:, None, :]
    A = A * fm + (1.0 - fm) * eye + lam * free[:, :, None] * eye
    B = B * free[:, :, None] * torch.roll(free, 1, dims=0)[:, None, :]
    B[0] = 0.0
    return A, B


def _scatter_tridiag(Hii, Hjj, Hij, i, j, chain_mask, N):
    """Tridiagonal contributions of edge rows by scatter: diagonal blocks at
    i and j, the sub-diagonal block T[max, max-1] for |i-j| == 1."""
    m = chain_mask[:, None, None].to(Hii.dtype)
    A = segment_sum(torch.cat([Hii * m, Hjj * m]), torch.cat([i, j]), N)
    # edge (i, j=i+1) puts Hij^T at B[i+1]; (i=j+1, j) puts Hij at B[i]
    sub_ok = (chain_mask & ((i - j).abs() == 1))[:, None, None].to(Hii.dtype)
    val = torch.where((j > i)[:, None, None], _T(Hij), Hij) * sub_ok
    return A, segment_sum(val, torch.maximum(i, j), N)


def assemble_tridiag(sys: LinSys, N, free, lam, chain_mask):
    """T as (A (N,D,D), B (N,D,D)) with B[k] = T[k,k-1], B[0] = 0."""
    Hii, Hjj, Hij = _edge_hessians(sys)
    A, B = _scatter_tridiag(Hii, Hjj, Hij, sys.i, sys.j, chain_mask, N)
    return finish_tridiag(A, B, free, lam)


def shift_chain(top, bot, sub, N):
    """Lay per-slot chain blocks into (A, B): slot k adds ``top`` at vertex
    k, ``bot`` at vertex k+1 and the sub-diagonal ``sub`` = T[k+1, k]."""
    nc = top.shape[0]
    A = top.new_zeros((N,) + tuple(top.shape[1:]))
    A[:nc] += top
    A[1:nc + 1] += bot
    B = torch.zeros_like(A)
    B[1:nc + 1] = sub
    return A, B


def assemble_tridiag_chain(sys: LinSys, N, free, lam, chain_mask, n_chain):
    """Shift-based assembly for the chain-first edge layout.

    Contract (SE2GraphBuilder.to_arrays(chain_first=True)): rows
    [0..n_chain-1] hold the consecutive odometry edges, row k connecting
    vertices {k, k+1} in either stored orientation (inactive slots have
    W = 0). The chain lands by shifts; the remaining rows (loops, priors,
    fixed-endpoint edges) are scattered, over E - n_chain rows only."""
    nc = n_chain
    Hii, Hjj, Hij = _edge_hessians(sys)
    # slot k stores (i=k, j=k+1) or (i=k+1, j=k): T[k+1, k] is Hij^T for
    # forward rows and Hij for reversed ones
    rev = (sys.i[:nc] > sys.j[:nc])[:, None, None]
    A, B = shift_chain(torch.where(rev, Hjj[:nc], Hii[:nc]),
                       torch.where(rev, Hii[:nc], Hjj[:nc]),
                       torch.where(rev, Hij[:nc], _T(Hij[:nc])), N)
    if sys.i.shape[0] > nc:
        At, Bt = _scatter_tridiag(Hii[nc:], Hjj[nc:], Hij[nc:], sys.i[nc:],
                                  sys.j[nc:], chain_mask[nc:], N)
        A, B = A + At, B + Bt
    return finish_tridiag(A, B, free, lam)


def _inv_blocks(A):
    """Batched small-block inverse; the closed-form adjugate for D = 3.

    Every block inverted here is an SPD reduced diagonal block of
    T = H + lam*I (Schur complements of an SPD matrix stay above its
    spectral floor lam), so the determinant stays away from zero."""
    if A.shape[-1] != 3:
        return torch.linalg.inv_ex(A).inverse
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 0], A[..., 1, 1], A[..., 1, 2]
    g, h, i = A[..., 2, 0], A[..., 2, 1], A[..., 2, 2]
    A00, A01, A02 = e * i - f * h, c * h - b * i, b * f - c * e
    A10, A11, A12 = f * g - d * i, a * i - c * g, c * d - a * f
    A20, A21, A22 = d * h - e * g, b * g - a * h, a * e - b * d
    det = a * A00 + b * A10 + c * A20
    adj = torch.stack([torch.stack([A00, A01, A02], -1),
                       torch.stack([A10, A11, A12], -1),
                       torch.stack([A20, A21, A22], -1)], -2)
    return adj / det[..., None, None]


def bcr_factor(A, B, base_blocks=1):
    """Cyclic-reduction factorization of the block-tridiagonal T.

    A (M,D,D), B (M,D,D) sub-diagonal (B[0] = 0); M a power of two.
    Reduces until at most ``base_blocks`` blocks remain and inverts those
    densely (the adjugate for a single 3x3 block). Returns (levels,
    base_inv); each level holds what a sweep of any right-hand side needs.
    """
    D = A.shape[1]
    levels = []
    while A.shape[0] > base_blocks:
        Ao_inv = _inv_blocks(A[1::2])
        B_o = B[1::2]                                        # B[o], o = 2t+1
        B_o1 = torch.cat([B[2::2], torch.zeros_like(B[:1])])  # B[o+1]
        B_e = B[0::2]                                        # B[k], k = 2t
        Ao_inv_Bo = Ao_inv @ B_o
        Ao_inv_B1T = Ao_inv @ _T(B_o1)
        levels.append((Ao_inv, B_o, B_e, Ao_inv_Bo, Ao_inv_B1T))
        A = (A[0::2] - _T(B_o) @ Ao_inv_Bo                   # right odd nbr
             - B_e @ torch.roll(Ao_inv_B1T, 1, dims=0))      # left odd nbr
        B = -(B_e @ torch.roll(Ao_inv_Bo, 1, dims=0))
        B[0] = 0.0

    Mb = A.shape[0]
    if Mb == 1:
        return levels, _inv_blocks(A[0])
    Hd = A.new_zeros((Mb, D, Mb, D))
    idx = torch.arange(Mb, device=A.device)
    Hd[idx, :, idx, :] = A
    Hd[idx[1:], :, idx[:-1], :] = B[1:]
    Hd[idx[:-1], :, idx[1:], :] = _T(B[1:])
    return levels, torch.linalg.inv_ex(Hd.reshape(Mb * D, Mb * D)).inverse


def bcr_apply(factors, g):
    """Solve T x = g with a bcr_factor result. g: (M,D,R)."""
    levels, base_inv = factors
    saved = []
    for Ao_inv, B_o, B_e, _, _ in levels:
        t1 = Ao_inv @ g[1::2]
        saved.append(t1)
        g = g[0::2] - _T(B_o) @ t1 - B_e @ torch.roll(t1, 1, dims=0)

    Mb, D, R = g.shape
    x = (base_inv @ g.reshape(Mb * D, R)).reshape(Mb, D, R)
    for (_, _, _, Ao_inv_Bo, Ao_inv_B1T), t1 in zip(reversed(levels),
                                                     reversed(saved)):
        x_right = torch.cat([x[1:], torch.zeros_like(x[:1])])
        x_odd = t1 - Ao_inv_Bo @ x - Ao_inv_B1T @ x_right
        x = torch.stack([x, x_odd], dim=1).reshape((-1,) + tuple(x.shape[1:]))
    return x


def _pad_to(x, P, fill_eye=False):
    """Append P - len(x) zero blocks (identity blocks with fill_eye)."""
    n = P - x.shape[0]
    if n == 0:
        return x
    pad = x.new_zeros((n,) + tuple(x.shape[1:]))
    if fill_eye:
        pad[:] = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    return torch.cat([x, pad])


def _coupling_rhs(ei, ej, Ji, Jj, free, N):
    """C^T as (N, D, K*D): column block k holds edge k's Ji^T at vertex ei[k]
    and Jj^T at ej[k]. Each (vertex, k) pair is written once per call, so
    no scatter-add is needed."""
    K, D = Ji.shape[0], Ji.shape[1]
    Ct = Ji.new_zeros((N, D, K, D))
    k = torch.arange(K, device=Ji.device)
    Ct[ei, :, k, :] = _T(Ji)
    Ct[ej, :, k, :] = Ct[ej, :, k, :] + _T(Jj)
    return (Ct * free[:, :, None, None]).reshape(N, D, K * D)


def _woodbury(u, V, off):
    """x = u - V (I + W C V_c)^{-1} W C u for u (N,D), V (N,D,K*D)."""
    ei, ej, Ji, Jj, W = off
    K, D = Ji.shape[0], Ji.shape[1]
    N = u.shape[0]
    CV = Ji @ V[ei] + Jj @ V[ej]                              # (K,D,K*D)
    Mcap = torch.eye(K * D, dtype=u.dtype, device=u.device) \
        + (W @ CV).reshape(K * D, K * D)
    WCu = bmv(W, bmv(Ji, u[ei]) + bmv(Jj, u[ej])).reshape(K * D)
    y = torch.linalg.solve_ex(Mcap, WCu).result
    return u - (V.reshape(N * D, K * D) @ y).reshape(N, D)


def chain_core_solve(A, B, b, free, N, off=None):
    """Direct solve on a preassembled tridiagonal (the chain_lm path).

    A, B: (N,D,D) with fixed-dim identity rows/cols and the LM damping
    already applied (B[0] = 0). b: (N,D) right-hand side. off: optional
    compacted off-chain table (ei, ej, Ji, Jj, W) of length K, inactive
    slots zero-weighted. The chain is padded with identity blocks to a
    power of two; one factorization, then ONE joint apply over [b | C^T],
    then the Woodbury correction.
    """
    P = 1 << max(int(N - 1).bit_length(), 2)
    factors = bcr_factor(_pad_to(A, P, fill_eye=True), _pad_to(B, P))
    rf = _pad_to((b * free)[:, :, None], P)
    if off is None:
        return bcr_apply(factors, rf)[:N, :, 0] * free
    Ct = _pad_to(_coupling_rhs(off[0], off[1], off[2], off[3], free, N), P)
    sol = bcr_apply(factors, torch.cat([rf, Ct], dim=-1))
    return _woodbury(sol[:N, :, 0], sol[:N, :, 1:], off) * free


def _offchain_compact(sys: LinSys, off_mask, K_cap):
    """The first K_cap off-chain edges in table order (a stable sort puts
    them first), inactive slots gated to zero; plus the overflow count."""
    order = torch.argsort((~off_mask).to(torch.int32), stable=True)[:K_cap]
    live = off_mask[order]
    gate = live[:, None, None].to(sys.W.dtype)
    return (sys.i[order], sys.j[order], sys.Ji[order] * gate,
            sys.Jj[order] * gate, sys.W[order] * gate,
            off_mask.sum() - live.sum())


def chain_solve(sys: LinSys, b, free, lam, N, K_cap=128, base_blocks=64,
                refine_steps=1, precision="df", n_chain=0):
    """Direct solve (H + lam I) x = b. Returns (x (N,D), n_dropped).

    n_dropped > 0 means more off-chain edges than K_cap; the caller should
    solve again with a bigger capacity. n_chain > 0 opts into the
    chain-first assembly (shifts instead of scatters). precision "df"
    runs in float64 and reduces to one block; "f32" runs in float32 with a
    dense base of ``base_blocks`` blocks.
    """
    if precision not in ("df", "f32"):
        raise ValueError(f"unknown chain_precision {precision!r}")
    out_dtype = b.dtype
    dt = torch.float64 if precision == "df" else torch.float32
    sys = LinSys(sys.i, sys.j, *(t.to(dt) for t in sys[2:]))
    b, free, lam = b.to(dt), free.to(dt), torch.as_tensor(lam).to(dt)
    K_cap = min(K_cap, sys.i.shape[0])  # tiny graphs: fewer edges than slots
    chain_mask, off_mask = _classify(sys, (free > 0).any(dim=1))

    P = 1 << max(int(N - 1).bit_length(), int(base_blocks).bit_length())
    if n_chain:
        A, B = assemble_tridiag_chain(sys, N, free, lam, chain_mask, n_chain)
    else:
        A, B = assemble_tridiag(sys, N, free, lam, chain_mask)
    factors = bcr_factor(_pad_to(A, P, fill_eye=True), _pad_to(B, P),
                         base_blocks=1 if precision == "df" else base_blocks)

    def apply_T(rhs):
        return bcr_apply(factors, _pad_to(rhs, P))[:N]

    if K_cap == 0:
        # pure chain solve (e.g. level-1 building refinement: every edge
        # is anchored on a frozen keyframe)
        n_drop = off_mask.sum()

        def solve_once(rhs):
            return apply_T((rhs * free)[:, :, None])[:, :, 0] * free
    else:
        ei, ej, Ji, Jj, W, n_drop = _offchain_compact(sys, off_mask, K_cap)
        off = (ei, ej, Ji, Jj, W)
        V = apply_T(_coupling_rhs(ei, ej, Ji, Jj, free, N))   # (N,D,K*D)

        def solve_once(rhs):
            u = apply_T((rhs * free)[:, :, None])[:, :, 0]
            return _woodbury(u, V, off) * free

    x = solve_once(b)
    for _ in range(refine_steps):
        x = x + solve_once(b * free - matvec(sys, x, free, lam))
    return x.to(out_dtype), n_drop
