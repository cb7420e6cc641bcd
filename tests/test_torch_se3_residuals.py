"""The SE3 solver's residuals at the canonical state and its branch-free LM
iteration, against the delta-parameterized evaluation they replace and
against the JAX package's optimize_se3.

graph/se3_solver.py evaluates every edge family through the plain error
functions at the state itself, once the state is canonical (unit
quaternions with w >= 0, unit plane normals); it used to evaluate the
``_f_*`` at zero delta, whose ``pose7_oplus(p, 0)`` / ``plane_oplus(pl, 0)``
canonicalize every endpoint on the way. The oracle below is that old
evaluation, kept verbatim.
"""

import numpy as np
import pytest
import torch

from delta_graph_slam_tpu.graph import SolverConfig as RConfig
from delta_graph_slam_tpu.graph import optimize_se3 as r_optimize_se3
from delta_graph_slam_tpu.graph import se3_graph as r_g
from delta_graph_slam_tpu_torch.graph import SolverConfig, optimize_se3
from delta_graph_slam_tpu_torch.graph import se3_solver as p_s

from test_torch_se3 import (  # noqa: E402
    FAMILIES, PBuilder, add_keyframes, every_edge_graph, hdl_messages,
)

torch.set_num_threads(2)


def oplus_families(graph, state, with_jac, live=None):
    """se3_solver._families as it was: every residual through its ``_f_*``
    at zero delta, on the state as it comes."""
    poses, planes, points = state
    V = poses.shape[0]
    P = planes.shape[0]
    g = graph

    def z(t, d):
        return poses.new_zeros((t.mask.shape[0], d))

    def prior(name):
        err_fn, dim = p_s._PRIORS[name]
        return (getattr(g, f"priors_{name}"), dim, lambda t: (
            t.i, t.i, p_s._f_prior(err_fn, z(t, 6), poses[t.i], t.meas),
            lambda: (p_s._j_prior(name, poses[t.i], t.meas), None)))

    specs = (
        (g.edges, 6, lambda t: (
            t.i, t.j, p_s._f_se3(z(t, 6), z(t, 6), poses[t.i], poses[t.j], t.meas),
            lambda: p_s._j_se3(poses[t.i], poses[t.j], t.meas))),
        prior("xy"), prior("xyz"), prior("vec"), prior("quat"),
        (g.se3_plane, 3, lambda t: (
            t.i, V + t.p,
            p_s._f_se3_plane(z(t, 6), z(t, 3), poses[t.i], planes[t.p], t.meas),
            lambda: p_s._j_se3_plane(poses[t.i], planes[t.p], t.meas))),
        (g.se3_point, 3, lambda t: (
            t.i, V + P + t.q,
            p_s._f_se3_point(z(t, 6), z(t, 3), poses[t.i], points[t.q], t.meas),
            lambda: p_s._j_se3_point(poses[t.i], points[t.q], t.meas))),
        (g.plane_plane, 4, lambda t: (
            V + t.a, V + t.b,
            p_s._f_pp(z(t, 3), z(t, 3), planes[t.a], planes[t.b], t.meas, t.kind),
            lambda: p_s._j_pp(planes[t.a], planes[t.b], t.meas, t.kind))),
        (g.plane_priors, 3, lambda t: (
            V + t.p, V + t.p, p_s._f_pprior(z(t, 3), planes[t.p], t.meas, t.kind),
            lambda: (p_s._j_pprior(planes[t.p], t.meas, t.kind), None))),
    )
    for k, (t, dim, place) in enumerate(specs):
        if live is not None and not live[k]:
            continue
        gi, gj, r, jac = place(t)
        Ji, Jj = jac() if with_jac else (None, None)
        yield gi, gj, r, Ji, Jj, t.info, t.mask, t.level, t.kernel, t.delta, dim


@pytest.fixture(scope="module")
def raw_graph():
    """The every-edge graph packed from float32 tables (quaternion norms off
    by ~1e-7), in float64, with every other quaternion negated (w < 0) and
    every plane normal 2% off unit length."""
    g = p_s._to_f64(every_edge_graph(PBuilder, dtype=np.float32).to_arrays(dtype=np.float32))
    poses = g.poses.clone()
    poses[1::2, 3:7] = -poses[1::2, 3:7]
    planes = g.planes.clone()
    planes[:, :3] *= 1.02
    assert (poses[:, 3] < 0).any()
    return g._replace(poses=poses, planes=planes)


def assert_close(got, want, what):
    """Float64: within 1e-12 of the array's largest magnitude."""
    got, want = got.numpy(), want.numpy()
    scale = max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * scale, err_msg=what)


@pytest.mark.parametrize("k", range(len(FAMILIES)), ids=FAMILIES)
def test_residuals_at_canonical_state_match_oplus_at_zero(raw_graph, k, monkeypatch):
    """Family by family: _linearize and _chi2 at _state0 (the canonical
    state) against the same passes through the old ``_f_*(0, ...)``
    evaluation of the raw state, LinSys, chi2 and the active count, to
    1e-12 relative. The raw state itself reads otherwise where an error
    function sees raw coefficients (the quaternion prior, the planes)."""
    g = raw_graph
    raw = (g.poses, g.planes, g.points)
    live = [i == k for i in range(len(FAMILIES))]
    got_sys, got_chi2 = p_s._linearize(g, p_s._state0(g), 0, live)
    got_c2, got_n = p_s._chi2(g, p_s._state0(g), 0, live)
    got_r = next(p_s._families(g, raw, False, live))[2]
    with monkeypatch.context() as m:
        m.setattr(p_s, "_families", oplus_families)
        want_sys, want_chi2 = p_s._linearize(g, raw, 0, live)
        want_c2, want_n = p_s._chi2(g, raw, 0, live)
    assert int(want_n) >= 1 and float(want_chi2) > 0.0
    for name in ("i", "j"):
        assert torch.equal(getattr(got_sys, name), getattr(want_sys, name))
    for name in ("r", "Ji", "Jj", "W"):
        assert_close(getattr(got_sys, name), getattr(want_sys, name), name)
    np.testing.assert_allclose(float(got_chi2), float(want_chi2), rtol=1e-12)
    np.testing.assert_allclose(float(got_c2), float(want_c2), rtol=1e-12)
    assert int(got_n) == int(want_n)
    gap = float((got_r - next(oplus_families(g, raw, False, live))[2]).abs().max())
    if FAMILIES[k] in ("quat", "se3plane", "pp", "pprior"):
        assert gap > 1e-9, gap
    else:
        assert gap < 1e-12, gap


# the hdl backend's solver settings, on the dense linear solve in both
# packages; ten keyframes with the floor hub, solved cold
HDL_SOLVER = dict(backend="dense", chi2_rel_tol=1e-6, max_iterations=100)


def test_lm_iterates_match_reference():
    """The port's branch-free LM iteration, run eagerly on the CPU, against
    the JAX package's while_loop on the same hdl graph: after 2 iterations
    and to convergence, the same iteration count, SolverStats (chi2 to 1e-9
    relative, lambda to 1e-6, active and dropped edge counts equal) and
    iterates (poses and the plane to 1e-9)."""
    msgs = hdl_messages(10)
    rb, pb = r_g.SE3GraphBuilder(), PBuilder()
    add_keyframes(rb, msgs, 0, 10, {})
    add_keyframes(pb, msgs, 0, 10, {})
    for cap in (2, HDL_SOLVER["max_iterations"]):
        solver = dict(HDL_SOLVER, max_iterations=cap)
        (rp, rpl, _), rs = r_optimize_se3(rb.to_arrays(), level=0, config=RConfig(**solver))
        (pp, ppl, _), ps = optimize_se3(pb.to_arrays(), level=0, config=SolverConfig(**solver))
        assert int(ps.iterations) == int(rs.iterations), (cap, ps.iterations, rs.iterations)
        assert 2 <= int(ps.iterations) < 100
        for name, rtol in (("chi2_initial", 1e-9), ("chi2_final", 1e-9),
                           ("lambda_final", 1e-6)):
            np.testing.assert_allclose(float(getattr(ps, name)), float(getattr(rs, name)),
                                       rtol=rtol, err_msg=name)
        assert int(ps.num_active_edges) == int(rs.num_active_edges)
        assert int(ps.n_offchain_dropped) == int(rs.n_offchain_dropped) == 0
        np.testing.assert_allclose(pp.numpy(), np.asarray(rp), rtol=0, atol=1e-9)
        np.testing.assert_allclose(ppl.numpy(), np.asarray(rpl), rtol=0, atol=1e-9)
