"""The port's SE3 graph (geom/se3.py, graph/se3_graph.py, se3_solver.py,
hub_solve.py, the SE3 half of graph_io.py) against the JAX package on the
CPU: the same numpy inputs through both, function by function.

The JAX package's own SE3 solves are slow tests (XLA compiles the D = 6
programs for minutes on the CPU), so functions are held against JAX called
eagerly, the hub solve against a float64 dense oracle, and whole solves
against the port's dense backend and one small JAX dense solve. The JAX
package's ``backend="chain"`` hub solve is compiled once (about 90 s) for
section (h): the hdl backend's warm cycles and a cold lap solved to
convergence, both at one set of capacities so the compiled program is
shared.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from delta_graph_slam_tpu.geom import se3 as r_se3
from delta_graph_slam_tpu.graph import se3_graph as r_g
from delta_graph_slam_tpu.graph import se3_solver as r_s
from delta_graph_slam_tpu.graph import SolverConfig as RConfig
from delta_graph_slam_tpu.graph import optimize_se3 as r_optimize_se3
from delta_graph_slam_tpu.graph.graph_io import load_g2o_se3 as r_load_g2o_se3
from delta_graph_slam_tpu.graph.graph_io import save_g2o_se3 as r_save_g2o_se3
from delta_graph_slam_tpu_torch.geom import se3 as p_se3
from delta_graph_slam_tpu_torch.graph import SolverConfig, optimize_se3
from delta_graph_slam_tpu_torch.graph import se3_graph as p_g
from delta_graph_slam_tpu_torch.graph import se3_solver as p_s
from delta_graph_slam_tpu_torch.graph.graph_io import load_g2o_se3, save_g2o_se3
from delta_graph_slam_tpu_torch.graph.hub_solve import chain_hub_solve, hub_overflow
from delta_graph_slam_tpu_torch.interop import se3_builder_from_reference
from delta_graph_slam_tpu_torch.ops.segment import deterministic
from delta_graph_slam_tpu_torch.pipeline.information_matrix import InformationMatrixCalculator

from test_torch_card import hub_dense_oracle, hub_linsys, hub_system  # noqa: E402

torch.set_num_threads(2)

PBuilder = functools.partial(p_g.SE3GraphBuilder, device="cpu")

# elementwise float math on both sides: float32 inputs agree to 1e-6,
# float64 ones to 1e-12
ATOL = {np.float32: 1e-6, np.float64: 1e-12}


def T(x):
    return torch.from_numpy(np.array(x))


def unit(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def rot_x(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]])


def rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])


def rot_z(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])


def pivot_rotations():
    """Rotations that take each of rot_to_quat's four constructions (trace,
    m00, m11, m22 largest), one with w < 0 before canonicalisation, and
    the identity (a tie of all four)."""
    return np.stack([
        np.eye(3), rot_z(0.3) @ rot_y(-0.2), rot_x(3.0), rot_y(3.0), rot_z(3.0),
        rot_x(np.pi), rot_y(np.pi), rot_z(np.pi), rot_z(-2.9) @ rot_x(0.4),
        rot_z(2.0) @ rot_y(2.0) @ rot_x(2.0),
    ])


def random_poses(rng, n, dtype=np.float64, scale=20.0):
    q = unit(rng.normal(size=(n, 4)))
    return np.concatenate([rng.normal(size=(n, 3)) * scale, q], 1).astype(dtype)


def random_planes(rng, n, dtype=np.float64):
    """Unit-normal planes; the first three sit on the poles and the x axis."""
    c = np.concatenate([unit(rng.normal(size=(n, 3))), rng.normal(size=(n, 1))], 1)
    c[0, :3] = [0.0, 0.0, 1.0]
    c[1, :3] = [0.0, 0.0, -1.0]
    c[2, :3] = [1.0, 0.0, 0.0]
    return c.astype(dtype)


# ------------------------------------------------------------ (a) geom/se3

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_se3_maps_match_reference(dtype):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(32, 4)).astype(dtype)
    R = np.concatenate([pivot_rotations(),
                        np.asarray(r_se3.quat_to_rot(jnp.asarray(q, jnp.float64)))]
                       ).astype(dtype)
    w = (rng.normal(size=(24, 3)) * 0.8).astype(dtype)
    w[:4] *= 1e-9                                 # the Taylor branches
    xi = np.concatenate([rng.normal(size=(24, 3)).astype(dtype), w], 1)
    Tm = np.asarray(r_se3.se3_exp(jnp.asarray(xi)))
    t = rng.normal(size=(len(R), 3)).astype(dtype)
    pairs = [
        (p_se3.quat_to_rot(T(q)), r_se3.quat_to_rot(jnp.asarray(q))),
        (p_se3.rot_to_quat(T(R)), r_se3.rot_to_quat(jnp.asarray(R))),
        (p_se3.se3_matrix(T(R), T(t)), r_se3.se3_matrix(jnp.asarray(R), jnp.asarray(t))),
        (p_se3.se3_matrix(quat=T(q)), r_se3.se3_matrix(quat=jnp.asarray(q))),
        (p_se3.se3_inverse(T(Tm)), r_se3.se3_inverse(jnp.asarray(Tm))),
        (p_se3.so3_exp(T(w)), r_se3.so3_exp(jnp.asarray(w))),
        (p_se3.se3_exp(T(xi)), r_se3.se3_exp(jnp.asarray(xi))),
        (p_se3.so3_log(T(Tm[:, :3, :3])), r_se3.so3_log(jnp.asarray(Tm[:, :3, :3]))),
        (p_se3.se3_log(T(Tm)), r_se3.se3_log(jnp.asarray(Tm))),
    ]
    for k, (got, want) in enumerate(pairs):
        assert got.numpy().dtype == dtype
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL[dtype], err_msg=f"pair {k}")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_se3_bridge_matches_reference(dtype):
    """se3_apply and the SE3 <-> SE2 bridge (euler_xyz_from_rot on both of
    Eigen's representatives, normalize_euler_angs, yaw_from_rot,
    transform_3d_to_2d / transform_2d_to_3d) as tensor functions."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(40, 4))
    q[:20, 1:3] *= 0.05                          # near-planar rotations
    R = np.concatenate([pivot_rotations(),
                        np.asarray(r_se3.quat_to_rot(jnp.asarray(q)))]).astype(dtype)
    Tm = np.asarray(r_se3.se3_matrix(jnp.asarray(R), jnp.asarray(
        rng.normal(size=(len(R), 3)) * 10.0))).astype(dtype)
    pts = rng.normal(size=(len(R), 7, 3)).astype(dtype) * 5
    euler = np.asarray(r_se3.euler_xyz_from_rot(jnp.asarray(R)))
    assert (euler[:, 0] >= 0).all() and (-np.asarray(R)[:, 1, 2] < 0).any()  # both branches
    p2 = (rng.normal(size=(len(R), 3)) * [20.0, 20.0, 3.0]).astype(dtype)
    pairs = [
        (p_se3.se3_apply(T(Tm), T(pts)), r_se3.se3_apply(jnp.asarray(Tm), jnp.asarray(pts))),
        (p_se3.euler_xyz_from_rot(T(R)), euler),
        (p_se3.normalize_euler_angs(T(euler.astype(dtype))),
         r_se3.normalize_euler_angs(jnp.asarray(euler.astype(dtype)))),
        (p_se3.yaw_from_rot(T(R)), r_se3.yaw_from_rot(jnp.asarray(R))),
        (p_se3.transform_3d_to_2d(T(Tm)), r_se3.transform_3d_to_2d(jnp.asarray(Tm))),
        (p_se3.transform_2d_to_3d(T(p2)), r_se3.transform_2d_to_3d(jnp.asarray(p2))),
    ]
    for k, (got, want) in enumerate(pairs):
        assert got.numpy().dtype == dtype
        # a 5e-5 rad float32 bound for angles of near-gimbal rotations, where
        # atan2 of a tiny pair turns with the last bit; roundoff in float64
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol={np.float32: 5e-5, np.float64: 1e-12}[dtype],
                                   err_msg=f"pair {k}")
    # the host twins the backends use agree with the tensor functions
    from delta_graph_slam_tpu_torch.geom.host import transform_3d_to_2d_np

    Tm64 = Tm.astype(np.float64)
    np.testing.assert_allclose(np.stack([transform_3d_to_2d_np(x) for x in Tm64]),
                               p_se3.transform_3d_to_2d(T(Tm64)).numpy(), atol=1e-12)


def test_rot_to_quat_pivots_and_sign():
    """Every pivot is exercised, w >= 0 always, and the quaternion maps back
    to its rotation to 1e-12 (float64)."""
    R = pivot_rotations()
    cand = np.stack([np.trace(R, axis1=1, axis2=2), R[:, 0, 0], R[:, 1, 1],
                     R[:, 2, 2]], 1)
    assert set(np.argmax(cand, 1)) == {0, 1, 2, 3}
    q = p_se3.rot_to_quat(T(R))
    assert (q[:, 0] >= 0).all()
    np.testing.assert_allclose(p_se3.quat_to_rot(q).numpy(), R, atol=1e-12)
    # the same construction is picked on every tie: equal to an ulp
    np.testing.assert_allclose(
        q.numpy(), np.asarray(r_se3.rot_to_quat(jnp.asarray(R))), rtol=0, atol=1e-15)


# ------------------------------------------- (b) plane math, error functions

@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_plane_math_matches_reference(dtype):
    rng = np.random.default_rng(1)
    a, b = random_planes(rng, 16, dtype), random_planes(rng, 16, dtype)[::-1].copy()
    d = (rng.normal(size=(16, 3)) * 0.3).astype(dtype)
    d[5] = 0.0
    Tm = np.asarray(r_g.pose7_to_matrix(jnp.asarray(random_poses(rng, 16, dtype, 3.0))))
    pairs = [
        (p_g.plane_azimuth(T(a[:, :3])), r_g.plane_azimuth(jnp.asarray(a[:, :3]))),
        (p_g.plane_elevation(T(a[:, :3])), r_g.plane_elevation(jnp.asarray(a[:, :3]))),
        (p_g.plane_rotation(T(a[:, :3])), r_g.plane_rotation(jnp.asarray(a[:, :3]))),
        (p_g.plane_oplus(T(a), T(d)), r_g.plane_oplus(jnp.asarray(a), jnp.asarray(d))),
        (p_g.plane_ominus(T(a), T(b)), r_g.plane_ominus(jnp.asarray(a), jnp.asarray(b))),
        (p_g.transform_plane(T(Tm), T(a)),
         r_g.transform_plane(jnp.asarray(Tm), jnp.asarray(a))),
        (p_g.plane_normalize(T(a * 3)), r_g.plane_normalize(jnp.asarray(a * 3))),
    ]
    for k, (got, want) in enumerate(pairs):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL[dtype], err_msg=f"pair {k}")


def error_cases(dtype):
    """name -> (port function, reference function, argument arrays) on 12
    random edges; planes include both poles."""
    rng = np.random.default_rng(2)
    n = 12
    pi, pj, z = (random_poses(rng, n, dtype) for _ in range(3))
    z[:, :3] *= 0.1
    pl, pm = random_planes(rng, n, dtype), random_planes(rng, n, dtype)[::-1].copy()
    pts = (rng.normal(size=(n, 3)) * 5).astype(dtype)
    vec = np.concatenate([unit(rng.normal(size=(n, 3))),
                          unit(rng.normal(size=(n, 3)))], 1).astype(dtype)
    q = unit(rng.normal(size=(n, 4))).astype(dtype)
    q[q[:, 0] < 0] *= -1
    return {
        "se3": (p_g.error_se3, r_g.error_se3, (pi, pj, z)),
        "prior_xy": (p_g.error_se3_prior_xy, r_g.error_se3_prior_xy, (pi, pts[:, :2])),
        "prior_xyz": (p_g.error_se3_prior_xyz, r_g.error_se3_prior_xyz, (pi, pts)),
        "prior_vec": (p_g.error_se3_prior_vec, r_g.error_se3_prior_vec, (pi, vec)),
        "prior_quat": (p_g.error_se3_prior_quat, r_g.error_se3_prior_quat, (pi, q)),
        "se3_plane": (p_g.error_se3_plane, r_g.error_se3_plane, (pi, pl, pm)),
        "se3_point": (p_g.error_se3_point, r_g.error_se3_point, (pi, pts, pts[::-1] * 0.3)),
        "plane_identity": (p_g.error_plane_identity, r_g.error_plane_identity,
                           (pl, pm, pm * 0.1)),
        "plane_parallel": (p_g.error_plane_parallel, r_g.error_plane_parallel,
                           (pl, pm, pm[:, :3] * 0.1)),
        "plane_perpendicular": (p_g.error_plane_perpendicular,
                                r_g.error_plane_perpendicular, (pl, pm, pm[:, :3])),
        "plane_prior_normal": (p_g.error_plane_prior_normal, r_g.error_plane_prior_normal,
                               (pl, pm[:, :3])),
        "plane_prior_distance": (p_g.error_plane_prior_distance,
                                 r_g.error_plane_prior_distance, (pl, pts[:, 0])),
    }


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", sorted(error_cases(np.float64)))
def test_error_function_matches_reference(name, dtype):
    p_fn, r_fn, args = error_cases(dtype)[name]
    got = p_fn(*(T(a) for a in args))
    want = jax.vmap(r_fn)(*(jnp.asarray(a) for a in args))
    assert got.shape == want.shape
    # translations reach ~60 m here: float32 rounding of a 60 m difference
    # is ~4e-6, so the float32 tolerance scales with the arguments
    scale = max(1.0, max(float(np.abs(a).max()) for a in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL[dtype] * scale)


def test_pose7_oplus_matches_reference():
    rng = np.random.default_rng(3)
    p = random_poses(rng, 16)
    d = rng.normal(size=(16, 6)) * 0.2
    d[:3] = 0.0
    got = p_g.pose7_oplus(T(p), T(d))
    want = jax.vmap(r_g.pose7_oplus)(jnp.asarray(p), jnp.asarray(d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


# -------------------------------------------- the reference's test graph

def every_edge_graph(builder_cls, dtype=np.float64, n=10, seed=7):
    """A graph with every vertex kind and all twelve edge types, several
    robust kernels and one level-1 edge; built through the public add_*
    calls of either package's SE3GraphBuilder."""
    rng = np.random.default_rng(seed)
    b = builder_cls(dtype=dtype)

    def pose(k, noise):
        M = np.eye(4)
        M[:3, :3] = rot_z(0.15 * k + noise * rng.normal()) @ rot_y(0.02 * rng.normal() * (noise > 0))
        M[:3, 3] = [1.0 * k, 0.1 * k * k, 0.05 * k] + noise * rng.normal(size=3)
        return M

    gt = [pose(k, 0.0) for k in range(n)]
    for k in range(n):
        b.add_se3_node(gt[k] if k == 0 else pose(k, 0.05), fixed=(k == 0))
    for k in range(n - 1):
        b.add_se3_edge(k, k + 1, np.linalg.inv(gt[k]) @ gt[k + 1], np.eye(6) * 100)
    b.add_se3_edge(n - 1, 2, np.linalg.inv(gt[n - 1]) @ gt[2], np.eye(6) * 50,
                   kernel="Huber", delta=0.5)
    p0 = b.add_plane_node([0.0, 0.0, 1.0, 0.0])
    p1 = b.add_plane_node([0.0, 1.0, 0.05, -4.0])
    p2 = b.add_plane_node([0.02, 0.0, 1.0, 2.5], fixed=True)
    q0 = b.add_point_xyz_node([3.0, 2.0, 1.0])
    for k in range(0, n, 2):
        R, t = gt[k][:3, :3], gt[k][:3, 3]
        nl = R.T @ np.array([0.0, 0.0, 1.0])
        b.add_se3_plane_edge(k, p0, np.concatenate([nl, [float(nl @ (R.T @ t))]]),
                             np.eye(3) * 10, kernel="Cauchy", delta=2.0)
        b.add_se3_point_xyz_edge(k, q0, R.T @ (np.array([3.0, 2.2, 0.9]) - t), 25.0)
    b.add_se3_plane_edge(3, p1, [0.1, 0.99, 0.0, -3.5], np.eye(3))
    b.add_se3_prior_xy_edge(4, gt[4][:2, 3] + 0.1, np.eye(2) * 4)
    b.add_se3_prior_xyz_edge(6, gt[6][:3, 3] - 0.1, np.diag([1.0, 2.0, 3.0]), level=1)
    b.add_se3_prior_xyz_edge(7, gt[7][:3, 3], 2.0)
    b.add_se3_prior_vec_edge(5, [0.0, 0.0, 1.0], [0.05, -0.02, 9.7], np.eye(3) * 3)
    b.add_se3_prior_quat_edge(8, -np.asarray(r_se3.rot_to_quat(jnp.asarray(gt[8][:3, :3]))),
                              np.eye(3) * 20, kernel="Huber", delta=1.0)
    b.add_plane_identity_edge(p0, p2, [0.0, 0.0, 0.0, 2.4], np.eye(4) * 0.5)
    b.add_plane_parallel_edge(p0, p2, [0.0, 0.0, 0.0], np.eye(3) * 2)
    b.add_plane_perpendicular_edge(p0, p1, 5.0)
    b.add_plane_normal_prior_edge(p0, [0.0, 0.0, 1.0], np.eye(3) * 7)
    b.add_plane_distance_prior_edge(p1, 4.1, 3.0)
    return b


def assert_same_graph(got: p_g.SE3Graph, want):
    """Field by field, exact; the port's index tables are int64. With
    ``dtype=`` the reference casts its vertex arrays only and leaves the edge
    tables in the builder's dtype (x64 is on here; without it JAX casts them
    all), the port casts every float table: the reference's values are cast
    to the port's dtype before the comparison."""
    def same(g, w, name):
        g = g.numpy()
        np.testing.assert_array_equal(g, np.asarray(w).astype(g.dtype), err_msg=name)

    for name in p_g.SE3Graph._fields:
        g, w = getattr(got, name), getattr(want, name)
        if isinstance(g, torch.Tensor):
            same(g, w, name)
            continue
        for f in g._fields:
            same(getattr(g, f), getattr(w, f), f"{name}.{f}")


# --------------------------------------------------------- (d) to_arrays

@pytest.mark.parametrize("caps", [
    {}, dict(v_capacity=32, e_capacity=64, prior_capacity=16),
    dict(v_capacity=8, e_capacity=4, prior_capacity=2, dtype=np.float32),
], ids=["default", "capacities", "capacities_below_f32"])
def test_to_arrays_matches_reference(caps):
    ref = every_edge_graph(r_g.SE3GraphBuilder)
    port = se3_builder_from_reference(ref)
    assert port.num_vertices == ref.num_vertices and port.num_edges == ref.num_edges
    assert_same_graph(port.to_arrays(**caps), ref.to_arrays(**caps))


def test_builder_calls_match_reference():
    """The same add_* calls on both builders give the same packed graph
    (host-side quaternion conversion of 4x4 poses included, to 1e-15), the
    same edge ids, and update_from / remove_edge / set_pose act alike."""
    ref = every_edge_graph(r_g.SE3GraphBuilder)
    port = every_edge_graph(PBuilder)
    assert [e["id"] for e in port.edges] == [e["id"] for e in ref.edges]
    for a, b in zip(port.poses, ref.poses):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-15)
    gp, gr = port.to_arrays(), ref.to_arrays()
    np.testing.assert_allclose(gp.edges.meas.numpy(), np.asarray(gr.edges.meas),
                               rtol=0, atol=1e-15)
    for b in (ref, port):
        b.remove_edge(3)
        b.set_pose(2, np.eye(4))
        b.update_from(np.stack(b.poses) + 0.5, np.stack(b.planes) * 2,
                      np.stack(b.points) - 1)
    assert port.num_edges == ref.num_edges
    assert port.count_offchain() == 1
    for a, b in zip(port.poses + port.planes + port.points,
                    ref.poses + ref.planes + ref.points):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-15)


# ------------------------------------- (c) residuals and Jacobians per family

@pytest.fixture(scope="module")
def family_tables():
    """The every-edge graph in float64 for both packages, poses moved off
    the optimum, and each side's family list with Jacobians (the JAX ones
    evaluated eagerly, x64 on)."""
    ref = every_edge_graph(r_g.SE3GraphBuilder)
    gp = p_s._to_f64(se3_builder_from_reference(ref).to_arrays())
    gr = ref.to_arrays()
    from delta_graph_slam_tpu.geom.dfloat import DF

    state_r = (DF(gr.poses, jnp.zeros_like(gr.poses)), gr.planes,
               DF(gr.points, jnp.zeros_like(gr.points)))
    with jax.disable_jit():
        fam_r = list(r_s._families(gr, state_r, with_jac=True))
    fam_p = list(p_s._families(gp, p_s._state0(gp), with_jac=True))
    return fam_p, fam_r


FAMILIES = ["se3", "xy", "xyz", "vec", "quat", "se3plane", "se3point", "pp", "pprior"]


def forward_mode_jacobians(f, argnums, *args):
    """Jacobians of the batched ``f`` at the arguments ``argnums`` by
    torch.autograd.forward_ad: every row repeated once a delta dimension,
    the copies carrying the unit tangents."""
    import torch.autograd.forward_ad as fwAD

    E = args[0].shape[0]
    dims = [args[k].shape[-1] for k in argnums]
    D = sum(dims)
    with fwAD.dual_level():
        ins, off = [], 0
        for k, a in enumerate(args):
            rep = a[:, None].expand((E, D) + tuple(a.shape[1:]))
            if k in argnums:
                tangent = a.new_zeros((E, D, a.shape[-1]))
                tangent[:, off:off + a.shape[-1]] = torch.eye(a.shape[-1], dtype=a.dtype)
                rep = fwAD.make_dual(rep.contiguous(), tangent)
                off += a.shape[-1]
            ins.append(rep)
        J = fwAD.unpack_dual(f(*ins)).tangent
    return torch.split(J.transpose(1, 2), dims, dim=2)


def jacobian_cases():
    """name -> (delta-parameterized function, delta argnums, closed form,
    its arguments) on 16 random edges far from any optimum; planes on both
    poles and the x axis, quaternions of either sign and not unit, pose
    priors against flipped quaternions."""
    import functools

    rng = np.random.default_rng(5)
    n = 16
    pi, pj, z = (random_poses(rng, n) for _ in range(3))
    pi[:, 3:7] *= rng.uniform(0.5, 2.0, (n, 1))
    z[:, :3] *= 0.1
    pl, pm = random_planes(rng, n), random_planes(rng, n)[::-1].copy()
    pl[:, :3] *= rng.uniform(0.5, 2.0, (n, 1))
    pts = rng.normal(size=(n, 3)) * 5
    vec = np.concatenate([unit(rng.normal(size=(n, 3))), unit(rng.normal(size=(n, 3)))], 1)
    q = unit(rng.normal(size=(n, 4)))
    q[q[:, 0] < 0] *= -1
    kind3 = np.arange(n) % 3
    kind2 = np.arange(n) % 2
    # the hdl backend's common case and the padded slots: level poses (yaw
    # only) seeing a level floor put the local normal exactly on a pole
    pi[0, 3:7] = [np.cos(0.4), 0.0, 0.0, np.sin(0.4)]
    pi[1, 3:7] = [1.0, 0.0, 0.0, 0.0]
    pi[2, 3:7] = [-np.cos(1.1), 0.0, 0.0, -np.sin(1.1)]
    pm[0], pm[1] = [0.0, 0.0, 1.0, 1.8], [0.0, 0.0, 1.0, 0.0]
    z6, z3 = np.zeros((n, 6)), np.zeros((n, 3))
    A = lambda *xs: tuple(T(x) for x in xs)    # noqa: E731
    cases = {
        "se3": (p_s._f_se3, (0, 1), p_s._j_se3, A(z6, z6, pi, pj, z)),
        "se3plane": (p_s._f_se3_plane, (0, 1), p_s._j_se3_plane, A(z6, z3, pi, pl, pm)),
        "se3point": (p_s._f_se3_point, (0, 1), p_s._j_se3_point, A(z6, z3, pi, pts, pts[::-1] * 0.3)),
        "pp": (p_s._f_pp, (0, 1), p_s._j_pp, A(z3, z3, pl, pm, pm * 0.1, kind3)),
        "pprior": (p_s._f_pprior, (0,), p_s._j_pprior, A(z3, pl, pm[:, :3], kind2)),
    }
    for name, meas in (("xy", pts[:, :2]), ("xyz", pts), ("vec", vec), ("quat", q)):
        cases[name] = (functools.partial(p_s._f_prior, p_s._PRIORS[name][0]), (0,),
                       functools.partial(p_s._j_prior, name), A(z6, pi, meas))
    return cases


@pytest.mark.parametrize("name", FAMILIES)
def test_closed_form_jacobian_matches_forward_mode(name):
    """Each closed form is the forward-mode derivative of its
    delta-parameterized error function at zero, to 1e-12 (float64)."""
    f, argnums, jfn, args = jacobian_cases()[name]
    want = forward_mode_jacobians(f, argnums, *args)
    got = jfn(*args[len(argnums):])
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("k", range(len(FAMILIES)), ids=FAMILIES)
def test_family_residual_and_jacobian_match_reference(family_tables, k):
    fam_p, fam_r = family_tables
    gi, gj, r, Ji, Jj, info, mask, lvl, kern, delta, dim = fam_p[k]
    wi, wj, wr, wJi, wJj, winfo, wmask, wlvl, wkern, wdelta, wdim = fam_r[k]
    assert dim == wdim and int(mask.sum()) >= 1
    np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
    np.testing.assert_array_equal(gj.numpy(), np.asarray(wj))
    # float64 on both sides (the reference's lo limbs are zero): 1e-10
    np.testing.assert_allclose(r.numpy(), np.asarray(wr), rtol=0, atol=1e-10)
    np.testing.assert_allclose(Ji.numpy(), np.asarray(wJi), rtol=0, atol=1e-10)
    assert (Jj is None) == (wJj is None)
    if Jj is not None:
        np.testing.assert_allclose(Jj.numpy(), np.asarray(wJj), rtol=0, atol=1e-10)
    assert torch.isfinite(Ji).all(), "padded slots must give finite Jacobians"


def test_free_mask_and_chi2(family_tables):
    """_free_mask against a numpy count over the builder's edges (vertices
    touched by an edge of the level, allocated, not fixed; planes and points
    own 3 dims), and _chi2 against the reference's robust_rho over the
    reference's residuals."""
    from delta_graph_slam_tpu.graph.robust import robust_rho as r_rho

    ref = every_edge_graph(r_g.SE3GraphBuilder)
    gp = p_s._to_f64(se3_builder_from_reference(ref).to_arrays())
    V, P, Q = gp.poses.shape[0], gp.planes.shape[0], gp.points.shape[0]
    ends = {"se3": ("i", "j"), "se3plane": ("i", "p"), "se3point": ("i", "q"),
            "pp": ("a", "b"), "pprior": ("p", "p")}
    base = {"i": 0, "j": 0, "p": V, "a": V, "b": V, "q": V + P}
    for level in (0, 1):
        touched = np.zeros(V + P + Q, bool)
        for e in ref.edges:
            if e["level"] == level:
                for f in ends.get(e["type"], ("i", "i")):
                    touched[base[f] + e[f]] = True
        fixed = np.zeros(V + P + Q, bool)
        fixed[:len(ref.fixed)] = ref.fixed
        fixed[V:V + len(ref.plane_fixed)] = ref.plane_fixed
        want = np.zeros((V + P + Q, 6))
        want[touched & ~fixed, :3] = 1.0
        want[:V][(touched & ~fixed)[:V], 3:] = 1.0
        np.testing.assert_array_equal(p_s._free_mask(gp, level).numpy(), want)

    _, fam_r = family_tables
    want_chi2 = 0.0
    for _, _, r, _, _, info, mask, lvl, kern, delta, dim in fam_r:
        rr = np.asarray(r).reshape(r.shape[0], -1)[:, :dim]
        ii = np.asarray(info)[:, :dim, :dim]
        rho = np.asarray(r_rho(jnp.asarray(np.einsum("ea,eab,eb->e", rr, ii, rr)),
                               kern, delta))
        want_chi2 += rho[np.asarray(mask) & (np.asarray(lvl) == 0)].sum()
    chi2, nact = p_s._chi2(gp, p_s._state0(gp), 0)
    assert int(nact) == sum(e["level"] == 0 for e in ref.edges)
    np.testing.assert_allclose(float(chi2), want_chi2, rtol=1e-12)
    np.testing.assert_allclose(float(p_s._linearize(gp, p_s._state0(gp), 0)[1]),
                               float(chi2), rtol=1e-14)


# ------------------------------------------------------------ (e) hub solve

@pytest.mark.parametrize("lam", [1e-2, 1e-6])
def test_hub_solve_matches_f64_dense(lam):
    rows, free, b, N = hub_system()
    with deterministic():
        x, nd = chain_hub_solve(hub_linsys(rows), T(b).double(), T(free),
                                torch.tensor(lam, dtype=torch.float64), N,
                                n_hub=2, K_cap=4, coup_cap=8)
    assert int(nd) == 0
    ref = hub_dense_oracle(rows, b, free, lam, N)
    err = np.linalg.norm(x.numpy() - ref) / np.linalg.norm(ref)
    # native float64 elimination (the reference's double-float one is held
    # to 1e-5); reached here: 5e-14 at lam 1e-2, 4e-13 at lam 1e-6
    assert err < 1e-9, f"relative step error {err} at lam={lam}"


def test_hub_solve_overflow_counts():
    """tests/test_graph.py:659-670: 5 couplings at capacity 3 drop 2, the
    one loop fits its 4 slots; float32 in, float32 out."""
    rows, free, b, N = hub_system()
    sysm = hub_linsys(rows)
    with deterministic():
        x, nd = chain_hub_solve(sysm, T(b), T(free), 1e-3, N, n_hub=2, K_cap=4,
                                coup_cap=3)
    assert int(nd) == 2 and x.dtype == torch.float32 and torch.isfinite(x).all()
    assert int(hub_overflow(sysm, T(free), N, 2, 4, 3)) == 2
    assert int(hub_overflow(sysm, T(free), N, 2, 0, 8)) == 1


# ------------------------------------------------------- (f) whole solves

def plane_loop_graph(builder_cls, n, seed=11, priors=True):
    """n poses on an arc above a z = 0 floor seen from every pose, one Huber
    loop and, with ``priors``, a prior of each kind."""
    rng = np.random.default_rng(seed)
    b = builder_cls()
    gt = []
    for k in range(n):
        M = np.eye(4)
        M[:3, :3] = rot_z(2 * np.pi * k / n)
        M[:3, 3] = [4 * np.cos(2 * np.pi * k / n), 4 * np.sin(2 * np.pi * k / n), 1.5]
        gt.append(M)
    for k in range(n):
        M = gt[k].copy()
        if k:
            M[:3, 3] += rng.normal(0, 0.08, 3)
            M[:3, :3] = M[:3, :3] @ rot_y(rng.normal(0, 0.02)) @ rot_z(rng.normal(0, 0.03))
        b.add_se3_node(M, fixed=(k == 0))
    for k in range(n - 1):
        b.add_se3_edge(k, k + 1, np.linalg.inv(gt[k]) @ gt[k + 1], np.eye(6) * 100)
    b.add_se3_edge(n - 1, 0, np.linalg.inv(gt[n - 1]) @ gt[0], np.eye(6) * 60,
                   kernel="Huber", delta=1.0)
    p = b.add_plane_node([0.0, 0.0, 1.0, 0.0])
    for k in range(n):
        R, t = gt[k][:3, :3], gt[k][:3, 3]
        nl = R.T @ np.array([0.0, 0.0, 1.0])
        b.add_se3_plane_edge(k, p, np.concatenate([nl, [float(nl @ (R.T @ t))]]),
                             np.eye(3) * 10)
    if priors:
        b.add_se3_prior_xy_edge(3, gt[3][:2, 3], np.eye(2) * 5)
        b.add_se3_prior_xyz_edge(5, gt[5][:3, 3], np.eye(3) * 5)
        b.add_se3_prior_vec_edge(7, [0.0, 0.0, 1.0], [0.0, 0.0, 9.8], np.eye(3) * 3)
        b.add_se3_prior_quat_edge(9, np.asarray(r_se3.rot_to_quat(jnp.asarray(gt[9][:3, :3]))),
                                  np.eye(3) * 10)
    return b


def test_optimize_se3_chain_matches_dense():
    b = plane_loop_graph(PBuilder, 24)
    g = b.to_arrays()
    (pd, pld, _), sd = optimize_se3(g, config=SolverConfig(backend="dense"))
    (pc, plc, _), sc = optimize_se3(g, config=SolverConfig(backend="chain"),
                                    n_offchain=b.count_offchain())
    assert int(sc.n_offchain_dropped) == 0 and sc.iterations > 3
    assert float(sc.chi2_final) < 1e-3 * float(sc.chi2_initial)
    # the same float64 LM with another linear solver: chi2 within 1e-6
    # relative, poses within 1e-5 m
    np.testing.assert_allclose(float(sc.chi2_final), float(sd.chi2_final), rtol=1e-6,
                               atol=1e-12)
    np.testing.assert_allclose(pc.numpy(), pd.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(plc.numpy(), pld.numpy(), rtol=0, atol=1e-5)
    # the host-side count optimize_se3 takes equals the one it reads itself
    (pc2, _, _), sc2 = optimize_se3(g, config=SolverConfig(backend="chain"))
    assert torch.equal(pc2, pc) and sc2.iterations == sc.iterations


def test_optimize_se3_matches_reference_dense():
    """12 poses, one plane hub with 12 se3plane edges, one Huber loop: the
    port's chain backend against the JAX package's dense backend."""
    ref = plane_loop_graph(r_g.SE3GraphBuilder, 12, priors=False)
    port = se3_builder_from_reference(ref)
    (wp, wpl, _), ws = r_optimize_se3(ref.to_arrays(), level=0,
                                      config=RConfig(backend="dense"))
    (gp, gpl, _), gs = optimize_se3(port.to_arrays(), level=0,
                                    config=SolverConfig(backend="chain"))
    chi2_g, chi2_w = float(gs.chi2_final), float(ws.chi2_final)
    np.testing.assert_allclose(float(gs.chi2_initial), float(ws.chi2_initial), rtol=1e-9)
    # chi2 within 1e-4 relative or both under 1e-10; poses within 1e-5 m
    assert (abs(chi2_g - chi2_w) <= 1e-4 * chi2_w) or max(chi2_g, chi2_w) < 1e-10, (
        chi2_g, chi2_w)
    np.testing.assert_allclose(gp.numpy(), np.asarray(wp), rtol=0, atol=1e-5)
    np.testing.assert_allclose(gpl.numpy(), np.asarray(wpl), rtol=0, atol=1e-5)


def test_optimize_se3_min_edges_skip_and_dtype():
    """A graph under min_edges is skipped (iterations -1, state returned as
    it came), and a float32 graph gets float32 state back; chain_segments
    changes nothing on SE3 (the JAX package ignores it there too:
    tests/test_torch_se3_segments.py)."""
    b = p_g.SE3GraphBuilder(device="cpu")
    b.add_se3_node(np.eye(4), fixed=True)
    b.add_se3_node(np.eye(4))
    b.add_se3_edge(0, 1, np.eye(4), np.eye(6))
    g = b.to_arrays(dtype=np.float32)
    (poses, planes, points), st = optimize_se3(g, config=SolverConfig(backend="chain"))
    assert st.iterations == -1 and poses.dtype == torch.float32
    assert torch.equal(poses, g.poses) and torch.equal(planes, g.planes)
    (poses4, planes4, _), st4 = optimize_se3(
        g, config=SolverConfig(backend="chain", chain_segments=4))
    assert st4.iterations == -1 and torch.equal(poses4, g.poses)
    assert torch.equal(planes4, g.planes)


# ------------------------------------------------------------- (g) g2o io

def test_g2o_se3_round_trip_with_reference(tmp_path):
    """save_g2o_se3 -> the JAX package's load_g2o_se3 -> its save_g2o_se3:
    the same text, and the same again through the port's loader."""
    ref = plane_loop_graph(r_g.SE3GraphBuilder, 12, priors=False)
    port = se3_builder_from_reference(ref)
    save_g2o_se3(port, tmp_path / "port.g2o")
    r_save_g2o_se3(ref, tmp_path / "ref.g2o")
    text = (tmp_path / "port.g2o").read_text()
    assert text == (tmp_path / "ref.g2o").read_text()
    assert ((tmp_path / "port.g2o.kernels").read_text()
            == (tmp_path / "ref.g2o.kernels").read_text())
    r_save_g2o_se3(r_load_g2o_se3(tmp_path / "port.g2o"), tmp_path / "ref_back.g2o")
    back = load_g2o_se3(tmp_path / "ref_back.g2o", device="cpu")
    save_g2o_se3(back, tmp_path / "port_back.g2o")
    assert (tmp_path / "port_back.g2o").read_text() == (tmp_path / "ref_back.g2o").read_text()
    assert len(back.poses) == len(port.poses) and len(back.planes) == 1
    assert back.fixed == port.fixed
    assert [(e["type"], e["kernel"]) for e in back.edges] == [
        (e["type"], e["kernel"]) for e in port.edges]
    # 12 significant digits in the text
    np.testing.assert_allclose(np.stack(back.poses), np.stack(port.poses), rtol=1e-11,
                               atol=1e-11)


# ------------------------------------- (h) the hdl backend's solves, chain

# the hdl backend's solver (HdlBackendConfig.solver) with a budget of 300
# iterations, which no solve here reaches, and one packing for every graph
# of this section, so the JAX chain program compiles once
HDL_SOLVER = dict(backend="chain", chi2_rel_tol=1e-6, max_iterations=300)
HDL_CAPS = dict(v_capacity=64, e_capacity=128, prior_capacity=64)
HDL_OFFRANK = 64


def hdl_messages(n, seed=7, odo_noise=(0.02, 0.003), loops=()):
    """What an hdl drive feeds its backend, in numpy: odometry poses with
    noise, fitness-based odometry informations (the reference's weights at
    fitness 0.02-0.1), the floor seen 1.8 m below every keyframe (the
    floor detector's coefficients, with noise) and loop measurements
    (i, j) from the ground truth. Ground truth: 2 m steps along a gentle
    curve, level, then back along it for the second half when ``loops``
    are asked for."""
    rng = np.random.default_rng(seed)
    half = n // 2 if loops else n
    gt = []
    for k in range(n):
        u = k if k < half else 2 * half - 1 - k
        M = np.eye(4)
        M[:3, :3] = rot_z(0.02 * u + (np.pi if k >= half else 0.0))
        M[:3, 3] = [2.0 * u, 0.02 * u * u + (1.0 if k >= half else 0.0), 0.0]
        gt.append(M)
    odom = [gt[0]]
    for k in range(1, n):
        noise = np.eye(4)
        noise[:3, :3] = (rot_z(rng.normal(0, odo_noise[1])) @ rot_x(rng.normal(0, 0.002))
                         @ rot_y(rng.normal(0, 0.002)))
        noise[:3, 3] = rng.normal(0, odo_noise[0], 3)
        odom.append(odom[-1] @ np.linalg.inv(gt[k - 1]) @ gt[k] @ noise)
    cal = InformationMatrixCalculator()
    infos = []
    for _ in range(n):
        wx, wq = cal._weights(float(rng.uniform(0.02, 0.1)))
        infos.append(np.diag([1 / wx] * 3 + [1 / wq] * 3))
    floors = []
    for k in range(n):
        nl = gt[k][:3, :3].T @ np.array([0.0, 0.0, 1.0]) + rng.normal(0, 0.002, 3)
        floors.append(np.concatenate([nl / np.linalg.norm(nl), [1.8 + rng.normal(0, 0.01)]]))
    loop_meas = [(i, j, np.linalg.inv(gt[i]) @ gt[j]) for i, j in loops]
    return odom, infos, floors, loop_meas


def add_keyframes(b, msgs, lo, hi, nodes):
    """Keyframes lo..hi-1 as HdlBackend.flush_keyframe_queue and
    flush_floor_queue add them: the first behind a fixed anchor, each new
    vertex at its raw odometry pose, an odometry edge from the previous
    keyframe, a floor edge (information I / 10^2) to the one plane."""
    odom, infos, floors, _ = msgs
    for k in range(lo, hi):
        node = b.add_se3_node(odom[k])
        if k == 0:
            anchor = b.add_se3_node(np.eye(4), fixed=True)
            b.add_se3_edge(anchor, node, np.eye(4), np.eye(6))
            nodes["plane"] = b.add_plane_node([0.0, 0.0, 1.0, 0.0])
        else:
            b.add_se3_edge(nodes[k - 1], node, np.linalg.inv(odom[k - 1]) @ odom[k],
                           infos[k])
        nodes[k] = node
        b.add_se3_plane_edge(node, nodes["plane"], floors[k], np.eye(3) / 100.0)


def both_solves(rb, pb):
    """One hdl-backend solve of the same graph in each package (the JAX
    package's chain backend and the port's), each writing its optimum back
    into its own builder as the backend's update_from does. Returns the two
    SolverStats."""
    rcfg, pcfg = RConfig(**HDL_SOLVER), SolverConfig(**HDL_SOLVER)
    (rp, rpl, rpt), rs = r_optimize_se3(rb.to_arrays(**HDL_CAPS), level=0, config=rcfg,
                                        offrank_floor=HDL_OFFRANK)
    (pp, ppl, ppt), ps = optimize_se3(pb.to_arrays(**HDL_CAPS), level=0, config=pcfg,
                                      offrank_floor=HDL_OFFRANK,
                                      n_offchain=pb.count_offchain())
    rb.update_from(np.asarray(rp), np.asarray(rpl), np.asarray(rpt))
    pb.update_from(pp, ppl, ppt)
    return rs, ps


def test_hdl_warm_cycles_iterate_as_the_reference():
    """ROADMAP Queue 3 item 1: the LM iterations of the hdl backend's warm
    cycles. Ten keyframes, then four more a cycle up to 34, each cycle
    warm-started from the previous optimum with the new vertices at their
    raw odometry poses: the JAX package's chain solve and the port's take
    the same number of iterations every cycle and end at the same chi2
    (1e-9 relative) and poses (1e-9 m). The count is the reference's own
    behaviour; what the card's drive spends (19-94 a cycle) comes with that
    drive's graph, not with the port's solver."""
    msgs = hdl_messages(34)
    rb, pb = r_g.SE3GraphBuilder(), PBuilder()
    rn, pn = {}, {}
    lo, cycles = 0, []
    for m in [10] + [4] * 6:
        add_keyframes(rb, msgs, lo, lo + m, rn)
        add_keyframes(pb, msgs, lo, lo + m, pn)
        lo += m
        rs, ps = both_solves(rb, pb)
        cycles.append((int(rs.iterations), int(ps.iterations)))
        np.testing.assert_allclose(float(ps.chi2_initial), float(rs.chi2_initial), rtol=1e-9)
        np.testing.assert_allclose(float(ps.chi2_final), float(rs.chi2_final), rtol=1e-9)
        np.testing.assert_allclose(np.stack(pb.poses), np.stack(rb.poses), rtol=0, atol=1e-9)
    assert [p for _, p in cycles] == [r for r, _ in cycles], cycles
    # every cycle stops on the relative-gain rule, well inside the budget
    assert all(2 <= r < 30 for r, _ in cycles), cycles


def test_hdl_lap_solve_matches_reference_two_sided():
    """ROADMAP Queue 3 item 2: a 60-node out-and-back hdl graph (the floor
    hub with 60 se3plane edges, 5 Huber loops, odometry drifting 5 cm and
    5 mrad a step), solved cold from the odometry by both packages with the
    same budget of 300 iterations, which neither reaches: the final chi2
    agree within 1e-6 relative both ways and the poses within 1e-6 m, so
    the port's chain + hub solve reaches the reference's optimum."""
    n = 60
    loops = [(n - 1 - k, k) for k in range(2, 27, 6)]
    msgs = hdl_messages(n, seed=11, odo_noise=(0.05, 0.005), loops=loops)
    rb, pb = r_g.SE3GraphBuilder(), PBuilder()
    rn, pn = {}, {}
    add_keyframes(rb, msgs, 0, n, rn)
    add_keyframes(pb, msgs, 0, n, pn)
    for b, nodes in ((rb, rn), (pb, pn)):
        for i, j, meas in msgs[3]:
            b.add_se3_edge(nodes[i], nodes[j], meas, np.eye(6) * 50, kernel="Huber", delta=1.0)
    rs, ps = both_solves(rb, pb)
    assert 3 < int(rs.iterations) < 300 and 3 < int(ps.iterations) < 300
    assert abs(int(ps.iterations) - int(rs.iterations)) <= 2
    chi2_p, chi2_r = float(ps.chi2_final), float(rs.chi2_final)
    assert chi2_p < 1e-2 * float(ps.chi2_initial)
    assert abs(chi2_p - chi2_r) <= 1e-6 * chi2_r, (chi2_p, chi2_r)
    np.testing.assert_allclose(np.stack(pb.poses), np.stack(rb.poses), rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.stack(pb.planes), np.stack(rb.planes), rtol=0, atol=1e-6)
