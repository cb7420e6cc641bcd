"""Generic block-sparse Levenberg-Marquardt machinery.

From-scratch replacement for g2o + CHOLMOD/CSparse/PCG
(graph_slam.cpp): edges are fixed-capacity tensors, the robustified normal
equations are assembled by segment sums, and the linear system is solved
densely (small graphs), by block-Jacobi preconditioned CG (matrix-free), or
by the direct chain solve (graph/chain_solve.py).

LM schedule of g2o's OptimizationAlgorithmLevenberg: initial lambda =
tau * max diag(H); accept/reject by chi2 with gain-ratio lambda updates.
The loop runs on the host. An iteration is one branch-free step
(``_lm_step``): the accepted step or the old iterate is picked on the
device, and the host reads one flag (keep going); chi2 and the other
statistics stay on the device until the solve returns. The linear algebra
uses the ``_ex`` forms (no error check), which would otherwise read a
status from the device on every call.

On a card, ``cuda_graph=True`` records the step once as a CUDA graph after
a first eager iteration and replays it from then on: an SE3 iteration is
thousands of tiny float64 launches, and one graph launch replaces them.

Every float scatter-add goes through ``segment_sum`` (ops/segment.py) and
the solve runs under ``deterministic()``, so a solve on the card gives the
same bits every run.
"""

import dataclasses
import threading
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
    # > 1 splits the chain of the fused SE2 chain LM (graph/chain_lm.py)
    # into this many segments, solved by SPIKE substructuring
    # (parallel/spike.py); optimize_se2 sets it for large graphs given a
    # local_hint, optimize_se2_sharded to the mesh axis size. The generic
    # LM and the SE3 solve ignore it, as in the JAX package
    chain_segments: int = 0
    # the JAX package's mesh axis for the segment dimension; on one card
    # the segments are a batch dimension and the name changes nothing
    chain_mesh_axis: str = None
    # > 0 (with chain_segments > 1 and off-chain edges) takes the
    # locality-aware segmented solve: each segment sweeps its right-hand
    # side, its two interfaces and up to chain_local_cols endpoint slots;
    # edges beyond the slots are dropped (counted in n_offchain_dropped)
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


def _pick(accept, new, old):
    """``new`` where the step was accepted, else ``old``: a tensor or a
    tuple of tensors."""
    if isinstance(old, torch.Tensor):
        return torch.where(accept, new, old)
    return tuple(torch.where(accept, a, b) for a, b in zip(new, old))


def _linear_solver(cfg: SolverConfig, free, N, n_chain):
    """(sys, b, lam) -> dx, the solve of (H + lam I) dx = -b by the
    configured backend."""
    if cfg.backend == "dense":
        return lambda sys, b, lam: dense_solve(sys, -b, free, lam)
    if cfg.backend == "chain" and cfg.chain_hubs > 0:
        from .hub_solve import chain_hub_solve

        return lambda sys, b, lam: chain_hub_solve(
            sys, -b, free, lam, N, n_hub=cfg.chain_hubs,
            K_cap=cfg.chain_offrank_capacity,
            coup_cap=cfg.chain_coupling_capacity)[0]
    if cfg.backend == "chain":
        from .chain_solve import chain_solve

        return lambda sys, b, lam: chain_solve(
            sys, -b, free, lam, N, K_cap=cfg.chain_offrank_capacity,
            base_blocks=cfg.chain_base_blocks, refine_steps=cfg.chain_refine_steps,
            precision=cfg.chain_precision, n_chain=n_chain)[0]

    def cg(sys, b, lam):
        Minv = block_jacobi_inverse(diag_blocks(sys, N), free, lam)
        return cg_solve(sys, -b, free, lam, Minv, cfg.cg_max_iters, cfg.cg_rtol)
    return cg


def _lm_step(carry, linearize_fn, apply_fn, solve, cfg: SolverConfig, N, n_chain):
    """One LM iteration without a host read: carry = (state, sys, chi2,
    lam, nu) -> (the next carry, a 0-d bool: keep going)."""
    state, sys, chi2, lam, nu = carry
    dtype = lam.dtype
    b = gradient(sys, N, n_chain=n_chain)
    dx = solve(sys, b, lam)
    trial = apply_fn(state, dx)
    sys_t, chi2_t = linearize_fn(trial)
    denom = (dx * (lam * dx - b)).sum()
    rho = (chi2 - chi2_t) / torch.where(torch.abs(denom) < 1e-30,
                                        torch.full_like(denom, 1e-30), denom)
    accept = (chi2_t < chi2) & _all_finite(trial)
    chi2_n = torch.where(accept, chi2_t, chi2)
    lam_dec = lam * torch.clamp(1.0 - (2.0 * rho - 1.0) ** 3, min=1.0 / 3.0)
    lam_n = torch.where(accept, lam_dec, lam * nu).to(dtype)
    nu_n = torch.where(accept, torch.full_like(nu, 2.0), nu * 2.0)
    # stop on an accepted step with negligible gain, or on a step so
    # small no progress is possible: the dx test applies to rejected
    # steps too, or the tail walks lambda up to 1e12
    converged = (accept & ((chi2 - chi2_n) <= cfg.chi2_rel_tol
                           * torch.clamp(chi2, min=1e-30))) \
        | ((dx * dx).sum() < cfg.dx_tol)
    sys_n = LinSys(sys.i, sys.j, *(torch.where(accept, a, o)
                                   for a, o in zip(sys_t[2:], sys[2:])))
    carry = (_pick(accept, trial, state), sys_n, chi2_n, lam_n, nu_n)
    return carry, ~converged & (lam_n < 1e12)


def _carry_tensors(carry):
    """The tensors an iteration rewrites (the edge indices never change)."""
    state, sys, chi2, lam, nu = carry
    states = [state] if isinstance(state, torch.Tensor) else list(state)
    return states + list(sys[2:]) + [chi2, lam, nu]


# per thread and card: the stream captures run on, and the last graph
# captured there. Each capture allocates from the last one's memory pool,
# which that graph's life keeps open (an unused pool cannot be entered
# again), so the memory of one capture is reused by the next
_CAPTURE = threading.local()


def _capture_step(step, carry):
    """Record ``step`` as a CUDA graph that reads the carry's tensors and
    writes the next carry back into them; returns (graph, its keep-going
    flag). Replay it on the current stream.

    The capture runs on a stream of its own (a capture cannot use the
    default stream) that carries no other work, with thread-local error
    checks so that the runner's other threads go on launching on the
    default stream meanwhile. No synchronize and no empty_cache here (which
    torch.cuda.graph would add): the optimizer thread may not wait on the
    front end's queue."""
    device = carry[2].device
    per_card = _CAPTURE.__dict__.setdefault("per_card", {})
    if device.index not in per_card:
        with torch.cuda.device(device):
            per_card[device.index] = (torch.cuda.Stream(), None)
    stream, last = per_card[device.index]
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=None if last is None else last.pool(),
                            capture_error_mode="thread_local")
        try:
            nxt, go = step(carry)
            for dst, src in zip(_carry_tensors(carry), _carry_tensors(nxt)):
                dst.copy_(src)
        finally:
            graph.capture_end()
    per_card[device.index] = (stream, graph)
    return graph, go


def lm_optimize(linearize_fn, chi2_fn, apply_fn, state0, free, cfg: SolverConfig,
                n_edges_total=None, cuda_graph=False):
    """Generic robust LM loop.

    linearize_fn(state) -> (LinSys, chi2); chi2_fn(state) -> (chi2, n_active);
    apply_fn(state, dx (N,D)) -> state. ``free`` (N,D) float mask.

    n_edges_total: edge count for the g2o min_edges skip. The reference
    checks the WHOLE graph's edge count before the level-masked
    initializeOptimization (graph_slam.cpp:338-346), so pass the unmasked
    count; None falls back to the level-active count.

    cuda_graph: on a card, run the first iteration eagerly, then capture
    the iteration once and replay it (the same launches on the same
    buffers, so the same bits); the functions must then read nothing back
    from the device. Ignored on the CPU.
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
    solve = _linear_solver(cfg, free, N, n_chain)

    def step(c):
        return _lm_step(c, linearize_fn, apply_fn, solve, cfg, N, n_chain)

    carry = (state0, sys0, chi2_0, lam, nu)
    skipped, lam_ok = torch.stack([skip, lam < 1e12]).tolist()
    go = not skipped and lam_ok
    graph = None
    it = 0
    while go and it < cfg.max_iterations:
        if graph is None and it > 0 and cuda_graph and free.is_cuda:
            graph, go_t = _capture_step(step, carry)
        if graph is not None:
            graph.replay()
        else:
            carry, go_t = step(carry)
        it += 1
        go = bool(go_t)
    state, _, chi2, lam, _ = carry

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
