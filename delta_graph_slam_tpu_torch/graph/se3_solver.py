"""Robust LM for the SE3 graph (poses + plane + point landmarks).

Vertices live in one unified 6-dim block space (planes and points use the
first 3 dims, the rest masked), so the lm_core machinery applies unchanged.
Each edge error is a function of its vertices' local updates
(right-multiplicative se3 exp for poses, g2o Plane3D::oplus for planes,
additive for points); the Jacobians are the exact derivatives of those
functions at zero, written in closed form (``_j_*``). The JAX package takes
them by forward-mode autodiff of the same functions; on the card that route
(``torch.func`` or ``torch.autograd.forward_ad``) costs thousands of small
launches an LM iteration, all paid on the host, so the port keeps the
delta-parameterized functions ``_f_*`` as the definition, evaluates the
residuals through them, and the tests hold every closed form against the
forward-mode derivative of its ``_f_*`` and against the JAX Jacobians.

Precision. The solver state, the residuals and the Jacobians are float64,
whatever the dtype of the graph's tables: at city scale (|t| ~ 300 m) a
float32 state swallows late LM updates and the residual differences
t_j - t_i cancel. The JAX package carries translations and points as
double-float pairs with a closed-form correction per family for the same
reason; with native float64 none of that is needed here. Float64 products
never run at reduced precision, so the matmul-precision switches of the
process do not reach this module.

Replaces g2o lm_var_cholmod for the SE3/hdl capability set
(graph_slam.cpp:31-76, 338-352).
"""

import dataclasses
import functools

import torch

from ..geom.se3 import _skew, quat_to_rot, rot_to_quat
from ..ops.segment import deterministic
from .lm_core import SolverConfig, concat_sys, lm_optimize, pad_block
from .robust import robust_rho, robust_weight
from .se3_graph import (
    SE3Graph,
    error_plane_identity,
    error_plane_parallel,
    error_plane_perpendicular,
    error_plane_prior_distance,
    error_plane_prior_normal,
    error_se3,
    error_se3_plane,
    error_se3_point,
    error_se3_prior_quat,
    error_se3_prior_vec,
    error_se3_prior_xy,
    error_se3_prior_xyz,
    plane_azimuth,
    plane_elevation,
    plane_oplus,
    plane_rotation,
    pose7_oplus,
)


# delta-parameterized error functions (the Jacobians are their derivatives
# at delta = 0); each takes leading batch dimensions

def _f_se3(da, db, pi, pj, meas):
    return error_se3(pose7_oplus(pi, da), pose7_oplus(pj, db), meas)


def _f_prior(err_fn, da, pi, meas):
    return err_fn(pose7_oplus(pi, da), meas)


def _f_se3_plane(da, db, pi, pl, meas):
    return error_se3_plane(pose7_oplus(pi, da), plane_oplus(pl, db), meas)


def _f_se3_point(da, db, pi, pt, meas):
    return error_se3_point(pose7_oplus(pi, da), pt + db, meas)


def _f_pp(da, db, p1, p2, meas, kind):
    a = plane_oplus(p1, da)
    b = plane_oplus(p2, db)
    e_id = error_plane_identity(a, b, meas)
    z = torch.zeros_like(e_id)
    e_par = torch.cat([error_plane_parallel(a, b, meas[..., :3]), z[..., :1]], -1)
    e_perp = torch.cat([error_plane_perpendicular(a, b, meas), z[..., :3]], -1)
    k = kind[..., None]
    return torch.where(k == 0, e_id, torch.where(k == 1, e_par, e_perp))


def _f_pprior(da, p, meas, kind):
    a = plane_oplus(p, da)
    e_n = error_plane_prior_normal(a, meas)
    e_d = torch.cat([error_plane_prior_distance(a, meas[..., 0]),
                     torch.zeros_like(e_n[..., :2])], -1)
    return torch.where(kind[..., None] == 0, e_n, e_d)


_PRIORS = {
    "xy": (error_se3_prior_xy, 2),
    "xyz": (error_se3_prior_xyz, 3),
    "vec": (error_se3_prior_vec, 3),
    "quat": (error_se3_prior_quat, 3),
}


# closed-form Jacobians at delta = 0 ---------------------------------------
# Pose update T' = T exp([rho, phi]): t' = t + R rho, R' = R exp(phi) to
# first order. Plane update (a, e, d): n' = n + a b1 + e b2 with b1, b2 the
# 2nd and 3rd columns of plane_rotation(n), w' = w - d.

def _T(a):
    return a.transpose(-1, -2)


def _mv(A, v):
    return (A @ v[..., None])[..., 0]


def _rows(*blocks):
    """Block matrix from rows of (E,r,c) blocks."""
    return torch.cat([torch.cat(row, dim=-1) for row in blocks], dim=-2)


def _canon_quat(p):
    """The unit quaternion of a pose with w >= 0: what pose7_oplus returns."""
    q = p[..., 3:7]
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return torch.where(q[..., :1] < 0, -q, q)


def _quat_vec_jac(q):
    """d vec(q (x) exp(phi)) / d phi = (w I + [v]x) / 2 for q = (w, v)."""
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    return 0.5 * (q[..., :1, None] * eye + _skew(q[..., 1:4]))


def _sign(a, b):
    """(...,1,1): -1 where the dot product of a and b is negative (the error
    functions flip one of them there), else +1."""
    return (1.0 - 2.0 * ((a * b).sum(-1) < 0.0).to(a.dtype))[..., None, None]


def _plane_tangent(pl):
    """(the plane as plane_oplus(pl, 0) returns it: unit normal, w kept;
    the (E,3,2) basis b1, b2 of the normal's update)."""
    n = pl[..., :3] / torch.clamp(
        torch.linalg.vector_norm(pl[..., :3], dim=-1, keepdim=True), min=1e-12)
    return torch.cat([n, pl[..., 3:]], dim=-1), plane_rotation(n)[..., :, 1:3]


def _azel_grad(n):
    """(E,2,3): gradients of plane_azimuth and plane_elevation, zero on the
    poles where both functions freeze their inputs."""
    x, y, z = n[..., 0], n[..., 1], n[..., 2]
    xy2 = x * x + y * y
    safe = xy2 > 1e-20
    xy2 = torch.where(safe, xy2, torch.ones_like(xy2))
    rho = torch.sqrt(xy2)
    n2 = xy2 + z * z
    zero = torch.zeros_like(x)
    G = torch.stack([torch.stack([-y / xy2, x / xy2, zero], -1),
                     torch.stack([-z * x / (rho * n2), -z * y / (rho * n2), rho / n2],
                                 -1)], -2)
    return torch.where(safe[..., None, None], G, torch.zeros_like(G))


def _j_se3(pi, pj, meas):
    RiT = _T(quat_to_rot(pi[..., 3:7]))
    RzT = _T(quat_to_rot(meas[..., 3:7]))
    Rrel = RiT @ quat_to_rot(pj[..., 3:7])
    trel = _mv(RiT, pj[..., :3] - pi[..., :3])
    Rd = RzT @ Rrel
    Q = _quat_vec_jac(rot_to_quat(Rd))
    z = torch.zeros_like(Rd)
    return (_rows((-RzT, RzT @ _skew(trel)), (z, -(Q @ _T(Rrel)))),
            _rows((Rd, z), (z, Q)))


def _j_prior(name, pi, meas):
    R = quat_to_rot(pi[..., 3:7])
    z = torch.zeros_like(R)
    if name == "xy":
        return torch.cat([R[..., :2, :], z[..., :2, :]], dim=-1)
    if name == "xyz":
        return torch.cat([R, z], dim=-1)
    if name == "vec":
        return torch.cat([z, _skew(_mv(_T(R), meas[..., :3]))], dim=-1)
    q = _canon_quat(pi)
    return torch.cat([z, _sign(q, meas) * _quat_vec_jac(q)], dim=-1)


def _j_se3_plane(pi, pl, meas):
    R = quat_to_rot(pi[..., 3:7])
    t = pi[..., :3]
    pl, basis = _plane_tangent(pl)
    nl = _mv(_T(R), pl[..., :3])                       # the plane's local normal
    # ominus: (azimuth, elevation) of nm = Rot(nl)^T m, Rot = Rz(az) Ry(-el)
    az, el = plane_azimuth(nl), plane_elevation(nl)
    ca, sa, ce, se = torch.cos(az), torch.sin(az), torch.cos(el), torch.sin(el)
    m = meas[..., :3]
    ux = ca * m[..., 0] + sa * m[..., 1]
    uy = -sa * m[..., 0] + ca * m[..., 1]
    nm = torch.stack([ce * ux + se * m[..., 2], uy, -se * ux + ce * m[..., 2]], -1)
    d_az = torch.stack([ce * uy, -ux, -se * uy], -1)                   # d nm / d az
    d_el = torch.stack([nm[..., 2], torch.zeros_like(ux), -nm[..., 0]], -1)
    g = _azel_grad(nl)
    dnm = d_az[..., :, None] * g[..., None, 0, :] + d_el[..., :, None] * g[..., None, 1, :]
    A = _azel_grad(nm) @ dnm                           # d (az, el) / d nl, (E,2,3)
    row = nl[..., None, :]                             # (E,1,3)
    tb = _mv(_T(basis), t)[..., None, :]               # t . b1, t . b2, (E,1,2)
    # the distance component m_w - (w + t . n): -nl . rho from the pose,
    # -(t . b) (a, e) + d from the plane
    Ji = _rows((torch.zeros_like(A), A @ _skew(nl)), (-row, torch.zeros_like(row)))
    Jj = _rows((A @ _T(R) @ basis, torch.zeros_like(A[..., :, :1])),
               (-tb, torch.ones_like(row[..., :1])))
    return Ji, Jj


def _j_se3_point(pi, pt, meas):
    RT = _T(quat_to_rot(pi[..., 3:7]))
    local = _mv(RT, pt - pi[..., :3])
    eye = torch.eye(3, dtype=RT.dtype, device=RT.device).expand(RT.shape)
    return torch.cat([-eye, _skew(local)], dim=-1), RT


def _plane_update(basis):
    """(E,4,3): d (n, w) / d (a, e, d) of plane_oplus."""
    top = torch.cat([basis, torch.zeros_like(basis[..., :, :1])], dim=-1)
    zero = torch.zeros_like(basis[..., :1, :1])
    return torch.cat([top, torch.cat([zero, zero, zero - 1.0], dim=-1)], dim=-2)


def _j_pp(p1, p2, meas, kind):
    a, Ba = _plane_tangent(p1)
    b, Bb = _plane_tangent(p2)
    Pa, Pb = _plane_update(Ba), _plane_update(Bb)
    z = torch.zeros_like(Pa[..., :1, :])
    s4 = _sign(a, b)
    s3 = _sign(a[..., :3], b[..., :3])
    perp_i = torch.cat([(_T(Pa[..., :3, :]) @ b[..., :3, None]).transpose(-1, -2),
                        z, z, z], dim=-2)
    perp_j = torch.cat([(_T(Pb[..., :3, :]) @ a[..., :3, None]).transpose(-1, -2),
                        z, z, z], dim=-2)
    k = kind[..., None, None]
    Ji = torch.where(k == 0, -Pa, torch.where(
        k == 1, torch.cat([-Pa[..., :3, :], z], dim=-2), perp_i))
    Jj = torch.where(k == 0, s4 * Pb, torch.where(
        k == 1, torch.cat([s3 * Pb[..., :3, :], z], dim=-2), perp_j))
    return Ji, Jj


def _j_pprior(p, meas, kind):
    a, B = _plane_tangent(p)
    P3 = _plane_update(B)
    z = torch.zeros_like(P3[..., :1, :])
    s = _sign(a[..., :3], meas)
    return torch.where(kind[..., None, None] == 0, s * P3[..., :3, :],
                       torch.cat([P3[..., 3:, :], z, z], dim=-2))


def _families(graph: SE3Graph, state, with_jac, live=None):
    """Yield (gi, gj, r, Ji, Jj, info, mask, level, kernel, delta, rdim) with
    global vertex indices over the unified [poses | planes | points] space,
    one family a table of the graph, in the tables' order.

    state = (poses (V,7), planes (P,4), points (Q,3)), float64. ``live``
    (one flag a table) leaves out the families whose tables hold no edge:
    their rows would all carry W = 0, and each costs a pass of launches."""
    poses, planes, points = state
    V = poses.shape[0]
    P = planes.shape[0]
    g = graph

    def z(t, d):
        return poses.new_zeros((t.mask.shape[0], d))

    def prior(name):
        err_fn, dim = _PRIORS[name]
        return (getattr(g, f"priors_{name}"), dim, lambda t: (
            t.i, t.i, _f_prior(err_fn, z(t, 6), poses[t.i], t.meas),
            lambda: (_j_prior(name, poses[t.i], t.meas), None)))

    # (table, residual dim, table -> (gi, gj, residual, Jacobian thunk))
    specs = (
        (g.edges, 6, lambda t: (
            t.i, t.j, _f_se3(z(t, 6), z(t, 6), poses[t.i], poses[t.j], t.meas),
            lambda: _j_se3(poses[t.i], poses[t.j], t.meas))),
        prior("xy"), prior("xyz"), prior("vec"), prior("quat"),
        (g.se3_plane, 3, lambda t: (
            t.i, V + t.p,
            _f_se3_plane(z(t, 6), z(t, 3), poses[t.i], planes[t.p], t.meas),
            lambda: _j_se3_plane(poses[t.i], planes[t.p], t.meas))),
        (g.se3_point, 3, lambda t: (
            t.i, V + P + t.q,
            _f_se3_point(z(t, 6), z(t, 3), poses[t.i], points[t.q], t.meas),
            lambda: _j_se3_point(poses[t.i], points[t.q], t.meas))),
        (g.plane_plane, 4, lambda t: (
            V + t.a, V + t.b,
            _f_pp(z(t, 3), z(t, 3), planes[t.a], planes[t.b], t.meas, t.kind),
            lambda: _j_pp(planes[t.a], planes[t.b], t.meas, t.kind))),
        (g.plane_priors, 3, lambda t: (
            V + t.p, V + t.p, _f_pprior(z(t, 3), planes[t.p], t.meas, t.kind),
            lambda: (_j_pprior(planes[t.p], t.meas, t.kind), None))),
    )
    for k, (t, dim, place) in enumerate(specs):
        if live is not None and not live[k]:
            continue
        gi, gj, r, jac = place(t)
        Ji, Jj = jac() if with_jac else (None, None)
        yield gi, gj, r, Ji, Jj, t.info, t.mask, t.level, t.kernel, t.delta, dim


def _e2(r, info, dim):
    rr = r.reshape(r.shape[0], -1)[:, :dim]
    ii = info.reshape(-1, info.shape[-1], info.shape[-1])[:, :dim, :dim]
    return rr, ii, torch.einsum("ea,eab,eb->e", rr, ii, rr)


def _chi2(graph, state, level, live=None):
    total = state[0].new_zeros(())
    nact = torch.zeros((), dtype=torch.int64, device=state[0].device)
    for _, _, r, _, _, info, mask, lvl, kern, delta, dim in _families(
            graph, state, False, live):
        act = mask & (lvl == level)
        _, _, e2 = _e2(r, info, dim)
        rho = robust_rho(e2, kern, delta)
        total = total + torch.where(act, rho, torch.zeros_like(rho)).sum()
        nact = nact + act.sum()
    return total, nact


def _linearize(graph, state, level, live=None):
    parts = []
    chi2 = state[0].new_zeros(())
    for gi, gj, r, Ji, Jj, info, mask, lvl, kern, delta, dim in _families(
            graph, state, True, live):
        act = mask & (lvl == level)
        rr, ii, e2 = _e2(r, info, dim)
        rho = robust_rho(e2, kern, delta)
        w = torch.where(act, robust_weight(e2, kern, delta), torch.zeros_like(e2))
        chi2 = chi2 + torch.where(act, rho, torch.zeros_like(rho)).sum()
        Wf = ii * w[:, None, None]
        Jic = Ji[:, :dim, :] if Ji is not None else None
        Jjc = Jj[:, :dim, :] if Jj is not None else None
        parts.append((gi, gj) + pad_block(rr, Jic, Jjc, Wf, dim, 6))
    return concat_sys(parts), chi2


def _state0(graph: SE3Graph):
    return (graph.poses, graph.planes, graph.points)


def _tables(graph: SE3Graph):
    return graph[9:]


def _free_mask(graph: SE3Graph, level):
    """(N,6) float64: dims of vertices touched by an active edge, allocated
    and not fixed; planes and points own their first 3 dims."""
    V = graph.poses.shape[0]
    P = graph.planes.shape[0]
    Q = graph.points.shape[0]
    dev = graph.poses.device
    cnt = torch.zeros(V + P + Q, dtype=torch.int64, device=dev)
    for gi, gj, _, _, _, _, mask, lvl, _, _, _ in _families(
            graph, _state0(graph), with_jac=False):
        act = (mask & (lvl == level)).to(torch.int64)
        cnt.index_put_((gi,), act, accumulate=True)
        cnt.index_put_((gj,), act, accumulate=True)
    fixed = torch.cat([graph.fixed, graph.plane_fixed, graph.point_fixed])
    alloc = torch.cat([graph.vmask, graph.plane_mask, graph.point_mask])
    free = (cnt > 0) & ~fixed & alloc
    dimmask = torch.ones((V + P + Q, 6), dtype=torch.bool, device=dev)
    dimmask[V:, 3:] = False
    return (free[:, None] & dimmask).to(torch.float64)


def _apply_update(V, P, state, dx):
    poses, planes, points = state
    return (pose7_oplus(poses, dx[:V]),
            plane_oplus(planes, dx[V:V + P, :3]),
            points + dx[V + P:, :3])


def _to_f64(graph: SE3Graph) -> SE3Graph:
    f64 = torch.float64
    return SE3Graph(
        graph.poses.to(f64), graph.fixed, graph.vmask,
        graph.planes.to(f64), graph.plane_fixed, graph.plane_mask,
        graph.points.to(f64), graph.point_fixed, graph.point_mask,
        *(t._replace(meas=t.meas.to(f64), info=t.info.to(f64),
                     delta=t.delta.to(f64)) for t in _tables(graph)))


def _optimize(graph: SE3Graph, level, cfg: SolverConfig):
    graph = _to_f64(graph)
    V = graph.poses.shape[0]
    P = graph.planes.shape[0]
    counts = torch.stack([t.mask.sum() for t in _tables(graph)])
    n_total = counts.sum()
    # one host read a solve: which tables hold an edge at all
    live = (counts > 0).tolist()
    return lm_optimize(
        lambda s: _linearize(graph, s, level, live),
        lambda s: _chi2(graph, s, level, live),
        functools.partial(_apply_update, V, P), _state0(graph),
        _free_mask(graph, level), cfg, n_edges_total=n_total)


def optimize_se3(graph: SE3Graph, level=0, config: SolverConfig = None,
                 offrank_floor: int = 0, n_offchain: int = None):
    """Optimize; returns ((poses, planes, points), SolverStats), the state in
    the graph's dtype.

    backend="chain" routes through the hub-elimination direct solve
    (graph/hub_solve.py): poses form the BCR chain, every plane/point slot
    is a hub vertex eliminated through its small dense block.
    offrank_floor: least loop-edge (Woodbury) capacity; the capacity doubles
    from there past the count of off-chain se3 edges.
    n_offchain: that count when the caller knows it on the host
    (``SE3GraphBuilder.count_offchain``); left None it is read from the
    graph's tables, which on the card is one host read.
    """
    config = config or SolverConfig()
    if config.chain_segments > 1:
        raise NotImplementedError(
            "chain_segments > 1 (the SPIKE solve of parallel/spike.py) is not "
            "ported")
    if config.backend == "chain":
        n_hub = graph.planes.shape[0] + graph.points.shape[0]
        # coupling capacity: every pose<->hub edge comes from the se3_plane /
        # se3_point tables, so their capacities are an exact bound
        coup_cap = graph.se3_plane.i.shape[0] + graph.se3_point.i.shape[0]
        if n_offchain is None:
            e = graph.edges
            n_offchain = int((e.mask & ((e.i - e.j).abs() > 1)).sum())
        k = max(4, offrank_floor)
        while k < n_offchain:
            k *= 2
        if (config.chain_hubs, config.chain_coupling_capacity,
                config.chain_offrank_capacity) != (n_hub, coup_cap, k):
            config = dataclasses.replace(
                config, chain_hubs=n_hub, chain_coupling_capacity=coup_cap,
                chain_offrank_capacity=k)
    with deterministic():
        state, stats = _optimize(graph, int(level), config)
    dt = graph.poses.dtype
    return tuple(s.to(dt) for s in state), stats
