"""Generic block-sparse Levenberg-Marquardt machinery.

From-scratch replacement for g2o + CHOLMOD/CSparse/PCG
(graph_slam.cpp): edges are fixed-capacity tensors, the robustified normal
equations are assembled by segment sums, and the linear system is solved
densely (small graphs), by block-Jacobi preconditioned CG (matrix-free), or
by the direct chain solve (graph/chain_solve.py).

LM schedule of g2o's OptimizationAlgorithmLevenberg: initial lambda =
tau * max diag(H); accept/reject by chi2 with gain-ratio lambda updates.
The loop runs on the host. Each iteration reads one pair of flags from
the device (step accepted, keep going); chi2 and the other statistics stay
on the device until the solve returns. The linear algebra uses the ``_ex``
forms (no error check), which would otherwise read a status from the
device on every call.

Every float scatter-add goes through ``segment_sum`` (ops/segment.py) and
the solve runs under ``deterministic()``, so a solve on the card gives the
same bits every run.
"""

import dataclasses
from typing import NamedTuple

import torch

from ..ops.segment import segment_sum


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    backend: str = "cg"          # 'cg' | 'chain' | 'dense'
    max_iterations: int = 100    # LM outer iterations (early-stopped)
    cg_max_iters: int = 50
    cg_rtol: float = 1e-5
    lm_tau: float = 1e-5
    min_edges: int = 10          # g2o facade skips tiny graphs (graph_slam.cpp:340)
    chi2_rel_tol: float = 1e-10
    dx_tol: float = 1e-12
    # 'chain' backend (graph/chain_solve.py): direct block-cyclic-reduction
    # solve of the odometry chain plus a Woodbury correction for up to
    # chain_offrank_capacity off-chain edges (loops)
    chain_offrank_capacity: int = 128
    chain_base_blocks: int = 16
    chain_refine_steps: int = 0
    # "df" (the JAX package's double-float) runs the chain elimination in
    # native float64 here; "f32" runs it in float32 (small graphs only)
    chain_precision: str = "df"
    # > 0: the se2 table has the chain-first layout
    # (SE2GraphBuilder.to_arrays(chain_first=True)) and rows
    # [0..chain_layout-1] are the consecutive odometry edges. Set through
    # optimize_se2(..., n_chain=...)
    chain_layout: int = 0
    # > 0 routes the chain backend through the hub-elimination solve
    # (graph/hub_solve.py): the LAST chain_hubs vertices of the unified
    # space are hub vertices (SE3 floor planes / landmarks), eliminated
    # exactly through their small dense block; their couplings join the
    # loop edges in one generalized Woodbury capacitance. optimize_se3 sets
    # it for backend="chain"
    chain_hubs: int = 0
    # capacity for pose<->hub coupling edges in the hub solve (one per
    # keyframe with a floor in the hdl pipeline)
    chain_coupling_capacity: int = 4096
    # the fields below configure a path of the JAX package that this port
    # does not have (the segmented SPIKE solve); they are kept so configs
    # carry across, and a value that asks for that path raises
    chain_segments: int = 0
    chain_mesh_axis: str = None
    chain_local_cols: int = 0


class SolverStats(NamedTuple):
    chi2_initial: torch.Tensor
    chi2_final: torch.Tensor
    iterations: int              # -1 when the min_edges gate skipped the solve
    lambda_final: torch.Tensor
    num_active_edges: torch.Tensor
    # chain backend: active off-chain edges beyond the Woodbury capacity
    # (0 elsewhere); non-zero means the solve dropped couplings
    n_offchain_dropped: torch.Tensor = None


def bmv(a, v):
    """Batched matrix-vector (...,m,k) @ (...,k) -> (...,m)."""
    return (a @ v[..., None])[..., 0]


def _T(a):
    return a.transpose(-1, -2)


class LinSys(NamedTuple):
    """Unified padded block edge table (unary edges have Jj = 0, j = i)."""

    i: torch.Tensor    # (E,)
    j: torch.Tensor    # (E,)
    r: torch.Tensor    # (E,D)
    Ji: torch.Tensor   # (E,D,D)
    Jj: torch.Tensor   # (E,D,D)
    W: torch.Tensor    # (E,D,D) robust-weighted information (0 if inactive)


def pad_block(r, Ji, Jj, W, rdim, D):
    """Pad an rdim-residual edge family to DxD blocks."""
    E = r.shape[0]
    r = r.reshape(E, rdim)
    Ji = Ji.reshape(E, rdim, -1)
    rD = r.new_zeros((E, D))
    rD[:, :rdim] = r
    JiD = r.new_zeros((E, D, D))
    JiD[:, :rdim, :Ji.shape[-1]] = Ji
    JjD = r.new_zeros((E, D, D))
    if Jj is not None:
        Jj = Jj.reshape(E, rdim, -1)
        JjD[:, :rdim, :Jj.shape[-1]] = Jj
    WD = r.new_zeros((E, D, D))
    WD[:, :rdim, :rdim] = W.reshape(E, rdim, rdim)
    return rD, JiD, JjD, WD


def concat_sys(parts):
    return LinSys(*(torch.cat([p[k] for p in parts]) for k in range(6)))


def gradient(sys: LinSys, N, n_chain=0):
    """b = sum J^T W r, summed per vertex. Returns (N,D).

    n_chain > 0: rows [0..n_chain-1] follow the chain-first layout (row k
    <-> vertices {k, k+1}, either stored orientation); they land by shifts
    instead of scatters."""
    Wr = bmv(sys.W, sys.r)
    bi = bmv(_T(sys.Ji), Wr)
    bj = bmv(_T(sys.Jj), Wr)
    if n_chain:
        D = bi.shape[1]
        # slot k may store the edge as (k, k+1) or reversed (k+1, k)
        rev = (sys.i[:n_chain] > sys.j[:n_chain])[:, None]
        top = torch.where(rev, bj[:n_chain], bi[:n_chain])   # at vertex k
        bot = torch.where(rev, bi[:n_chain], bj[:n_chain])   # at vertex k+1
        b = bi.new_zeros((N, D))
        b[:n_chain] += top
        b[1:n_chain + 1] += bot
        b = b + segment_sum(bi[n_chain:], sys.i[n_chain:], N)
        return b + segment_sum(bj[n_chain:], sys.j[n_chain:], N)
    return segment_sum(bi, sys.i, N) + segment_sum(bj, sys.j, N)


def diag_blocks(sys: LinSys, N):
    """Block diagonal of H. Returns (N,D,D)."""
    Dii = _T(sys.Ji) @ sys.W @ sys.Ji
    Djj = _T(sys.Jj) @ sys.W @ sys.Jj
    return segment_sum(Dii, sys.i, N) + segment_sum(Djj, sys.j, N)


def matvec(sys: LinSys, x, free, lam):
    """(H + lam I) x with per-dim free-mask projection. x, free: (N,D)."""
    xf = x * free
    Wy = bmv(sys.W, bmv(sys.Ji, xf[sys.i]) + bmv(sys.Jj, xf[sys.j]))
    z = segment_sum(bmv(_T(sys.Ji), Wy), sys.i, x.shape[0])
    z = z + segment_sum(bmv(_T(sys.Jj), Wy), sys.j, x.shape[0])
    return (z + lam * xf) * free


def block_jacobi_inverse(Dblocks, free, lam):
    """Inverse of (diag blocks + lam I) with masked dims neutralized."""
    D = Dblocks.shape[-1]
    eye = torch.eye(D, dtype=Dblocks.dtype, device=Dblocks.device)
    # masked dims -> identity rows/cols so the inverse exists
    fm = free[..., None] * free[..., None, :]
    A = Dblocks * fm + (1.0 - fm) * eye + lam * eye
    return torch.linalg.inv_ex(A).inverse * fm


def cg_solve(sys: LinSys, b, free, lam, Minv, max_iters, rtol):
    """Block-Jacobi preconditioned CG on (H + lam I) x = b.

    Runs ``max_iters`` iterations on the device and freezes the iterate
    once the residual meets the tolerance, which gives the result of a
    loop that stops there, without a host read per iteration."""
    bf = b * free
    tol2 = rtol * rtol * torch.clamp((bf * bf).sum(), min=1e-30)

    def apply_Minv(r):
        return bmv(Minv, r) * free

    def nz(v):
        return torch.where(torch.abs(v) < 1e-30, torch.full_like(v, 1e-30), v)

    x = torch.zeros_like(b)
    r = bf
    p = apply_Minv(r)
    rz = (r * p).sum()
    for _ in range(max_iters):
        live = (r * r).sum() > tol2
        Ap = matvec(sys, p, free, lam)
        alpha = rz / nz((p * Ap).sum())
        x_n = x + alpha * p
        r_n = r - alpha * Ap
        z = apply_Minv(r_n)
        rz_n = (r_n * z).sum()
        p_n = z + (rz_n / nz(rz)) * p
        x = torch.where(live, x_n, x)
        r = torch.where(live, r_n, r)
        p = torch.where(live, p_n, p)
        rz = torch.where(live, rz_n, rz)
    return x


def dense_solve(sys: LinSys, b, free, lam):
    """Materialized (N*D, N*D) solve for small graphs and verification."""
    N, D = b.shape
    WJi = sys.W @ sys.Ji
    WJj = sys.W @ sys.Jj
    a = torch.arange(D, device=b.device)

    def rows(v):
        return (D * v[:, None, None] + a[None, :, None]).expand(-1, D, D)

    def cols(v):
        return (D * v[:, None, None] + a[None, None, :]).expand(-1, D, D)

    H = b.new_zeros((N * D, N * D))
    for vr, vc, val in ((sys.i, sys.i, _T(sys.Ji) @ WJi),
                        (sys.i, sys.j, _T(sys.Ji) @ WJj),
                        (sys.j, sys.i, _T(sys.Jj) @ WJi),
                        (sys.j, sys.j, _T(sys.Jj) @ WJj)):
        H.index_put_((rows(vr), cols(vc)), val, accumulate=True)
    freev = free.reshape(-1)
    H = H * freev[:, None] * freev[None, :] + torch.diag(
        torch.where(freev > 0, lam, torch.ones_like(freev)))
    x = torch.linalg.solve_ex(H, b.reshape(-1) * freev).result
    return x.reshape(N, D) * free


def _all_finite(state):
    """A 0-d bool tensor: every value of the state (a tensor or a tuple of
    tensors) is finite."""
    if isinstance(state, torch.Tensor):
        return torch.isfinite(state).all()
    return torch.stack([torch.isfinite(s).all() for s in state]).all()


def lm_optimize(linearize_fn, chi2_fn, apply_fn, state0, free, cfg: SolverConfig,
                n_edges_total=None):
    """Generic robust LM loop.

    linearize_fn(state) -> (LinSys, chi2); chi2_fn(state) -> (chi2, n_active);
    apply_fn(state, dx (N,D)) -> state. ``free`` (N,D) float mask.

    n_edges_total: edge count for the g2o min_edges skip. The reference
    checks the WHOLE graph's edge count before the level-masked
    initializeOptimization (graph_slam.cpp:338-346), so pass the unmasked
    count; None falls back to the level-active count.
    """
    N = free.shape[0]
    dtype = free.dtype
    chi2_0, nact = chi2_fn(state0)
    skip = (nact if n_edges_total is None else n_edges_total) < cfg.min_edges

    sys0, _ = linearize_fn(state0)
    dg = torch.diagonal(diag_blocks(sys0, N), dim1=-2, dim2=-1)
    maxdiag = (torch.abs(dg) * free).max()
    lam = (cfg.lm_tau * torch.clamp(maxdiag, min=1e-12)).to(dtype)
    nu = torch.tensor(2.0, dtype=dtype, device=free.device)
    n_chain = cfg.chain_layout if cfg.backend == "chain" else 0
    state, sys, chi2 = state0, sys0, chi2_0

    skipped, lam_ok = torch.stack([skip, lam < 1e12]).tolist()
    go = not skipped and lam_ok
    it = 0
    while go and it < cfg.max_iterations:
        b = gradient(sys, N, n_chain=n_chain)
        if cfg.backend == "dense":
            dx = dense_solve(sys, -b, free, lam)
        elif cfg.backend == "chain" and cfg.chain_hubs > 0:
            from .hub_solve import chain_hub_solve

            dx, _ = chain_hub_solve(
                sys, -b, free, lam, N, n_hub=cfg.chain_hubs,
                K_cap=cfg.chain_offrank_capacity,
                coup_cap=cfg.chain_coupling_capacity,
            )
        elif cfg.backend == "chain":
            from .chain_solve import chain_solve

            dx, _ = chain_solve(
                sys, -b, free, lam, N, K_cap=cfg.chain_offrank_capacity,
                base_blocks=cfg.chain_base_blocks,
                refine_steps=cfg.chain_refine_steps,
                precision=cfg.chain_precision, n_chain=n_chain,
            )
        else:
            Minv = block_jacobi_inverse(diag_blocks(sys, N), free, lam)
            dx = cg_solve(sys, -b, free, lam, Minv, cfg.cg_max_iters, cfg.cg_rtol)
        trial = apply_fn(state, dx)
        sys_t, chi2_t = linearize_fn(trial)
        denom = (dx * (lam * dx - b)).sum()
        rho = (chi2 - chi2_t) / torch.where(torch.abs(denom) < 1e-30,
                                            torch.full_like(denom, 1e-30), denom)
        accept = (chi2_t < chi2) & _all_finite(trial)
        chi2_n = torch.where(accept, chi2_t, chi2)
        lam_dec = lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
        lam = torch.where(accept, lam_dec, lam * nu).to(dtype)
        nu = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
        # stop on an accepted step with negligible gain, or on a step so
        # small no progress is possible: the dx test applies to rejected
        # steps too, or the tail walks lambda up to 1e12
        converged = (accept & ((chi2 - chi2_n) <= cfg.chi2_rel_tol
                               * torch.clamp(chi2, min=1e-30))) \
            | ((dx * dx).sum() < cfg.dx_tol)
        chi2 = chi2_n
        it += 1
        took, go = torch.stack([accept, ~converged & (lam < 1e12)]).tolist()
        if took:
            state, sys = trial, sys_t

    if cfg.backend == "chain" and cfg.chain_hubs > 0:
        from .hub_solve import hub_overflow

        n_drop = hub_overflow(sys0, free, N, cfg.chain_hubs,
                              cfg.chain_offrank_capacity,
                              cfg.chain_coupling_capacity)
    elif cfg.backend == "chain":
        from .chain_solve import offchain_overflow

        n_drop = offchain_overflow(sys0, free, cfg.chain_offrank_capacity)
    else:
        n_drop = torch.zeros((), dtype=torch.int64, device=free.device)
    stats = SolverStats(
        chi2_initial=chi2_0, chi2_final=chi2,
        iterations=-1 if skipped else it, lambda_final=lam,
        num_active_edges=nact, n_offchain_dropped=n_drop,
    )
    return state, stats
