"""Parity of the port's pose-graph solver (graph/solver.py) with the JAX
reference: bcr, dense and pcg (chain and jacobi preconditioners) on a
drifting odometry chain with one robust loop factor and one prior factor,
graph_chi2, marginal_covariance, and the block-cyclic-reduction solve at odd
and masked counts (the cases of tests/test_graph.py:285-325)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import T

from rolo_tpu.geometry import se3 as jse3, so3 as jso3
from rolo_tpu.graph import add_between as jadd_between, empty_graph as jempty_graph
from rolo_tpu.graph import solver as jsolver

from rolo_tpu_torch.geometry import se3 as se3_t
from rolo_tpu_torch.graph import solver
from rolo_tpu_torch.graph.factors import BetweenFactors, PoseGraph, add_between, empty_graph

K, N = 32, 12  # capacity, live poses
# f32 GN from the same drifted start: the solutions agree to well below the
# drift the solve removes (~0.1 m)
POSE_TOL = 2e-4


def _rot(w):
    return np.asarray(jso3.exp(jnp.asarray(np.asarray(w, np.float32))))


@functools.lru_cache(maxsize=None)
def _problem():
    """A square loop of N poses (one pose every 30 deg, 2 m apart), noisy
    odometry measurements, a drifted estimate, one robust loop factor
    (last -> first) and one prior factor (2 -> 5), as numpy arrays."""
    rng = np.random.default_rng(33)
    step = jse3.SE3(jnp.asarray(_rot([0.0, 0.0, 2 * np.pi / N])), jnp.asarray([2.0, 0.0, 0.0]))
    true = [jse3.SE3(jnp.eye(3), jnp.zeros(3))]
    for _ in range(N - 1):
        true.append(true[-1].compose(step))
    odom_rot = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    odom_trans = np.zeros((K, 3), np.float32)
    est_rot = np.tile(np.eye(3, dtype=np.float32), (K, 1, 1))
    est_trans = np.zeros((K, 3), np.float32)
    est = true[0]
    for i in range(1, N):
        rel = true[i - 1].inverse().compose(true[i])
        odom_rot[i] = np.asarray(rel.rot)
        odom_trans[i] = np.asarray(rel.trans) + rng.normal(0, 0.03, 3).astype(np.float32)
        pert = jse3.SE3(jnp.asarray(_rot(rng.normal(0, 0.01, 3))),
                        jnp.asarray(rng.normal(0, 0.05, 3).astype(np.float32)))
        est = est.compose(rel).compose(pert)
        est_rot[i], est_trans[i] = np.asarray(est.rot), np.asarray(est.trans)
    loop = true[N - 1].inverse().compose(true[0])
    prior = true[2].inverse().compose(true[5])
    factors = {
        "loop": (N - 1, 0, np.asarray(loop.rot), np.asarray(loop.trans),
                 np.full(6, 1e-4, np.float32), np.float32(0.5)),
        "prior": (2, 5, np.asarray(prior.rot), np.asarray(prior.trans),
                  np.full(6, 1e-3, np.float32), None),
    }
    return odom_rot, odom_trans, est_rot, est_trans, factors


@functools.lru_cache(maxsize=None)
def _jax_graph():
    odom_rot, odom_trans, _, _, f = _problem()
    g = jempty_graph(K, 8, 8)
    g = g._replace(odom_rel_rot=jnp.asarray(odom_rot), odom_rel_trans=jnp.asarray(odom_trans))
    i, j, r, t, var, c = f["loop"]
    g = g._replace(loops=jadd_between(g.loops, i, j, jnp.asarray(r), jnp.asarray(t),
                                      jnp.asarray(var), robust_c=jnp.asarray(c)))
    i, j, r, t, var, _ = f["prior"]
    return g._replace(priors=jadd_between(g.priors, i, j, jnp.asarray(r), jnp.asarray(t),
                                          jnp.asarray(var)))


def _port_graph():
    odom_rot, odom_trans, _, _, f = _problem()
    g = empty_graph(K, 8, 8, "cpu")
    g.odom_rel_rot.copy_(T(odom_rot))
    g.odom_rel_trans.copy_(T(odom_trans))
    i, j, r, t, var, c = f["loop"]
    g = g._replace(loops=add_between(g.loops, i, j, T(r), T(t), T(var), robust_c=float(c)))
    i, j, r, t, var, _ = f["prior"]
    return g._replace(priors=add_between(g.priors, i, j, T(r), T(t), T(var)))


def _from_jax(jg) -> PoseGraph:
    def between(f):
        return BetweenFactors(*(T(x) for x in f))

    return PoseGraph(T(jg.odom_rel_rot), T(jg.odom_rel_trans), T(jg.first_rot),
                     T(jg.first_trans), between(jg.loops), between(jg.priors))


@functools.lru_cache(maxsize=None)
def _jax_solution(method, preconditioner="chain", count=N, gn_iterations=10):
    _, _, est_rot, est_trans, _ = _problem()
    return jsolver.solve_pose_graph(_jax_graph(), jnp.asarray(est_rot), jnp.asarray(est_trans),
                                    jnp.asarray(count), gn_iterations=gn_iterations,
                                    method=method, preconditioner=preconditioner)


def test_add_between_matches_reference():
    got, want = _port_graph(), _jax_graph()
    for name in ("loops", "priors"):
        for field in BetweenFactors._fields:
            np.testing.assert_array_equal(getattr(getattr(got, name), field).numpy(),
                                          np.asarray(getattr(getattr(want, name), field)),
                                          err_msg=f"{name}.{field}")


def _jax_chi2(rot, trans, count=N):
    return float(jax.jit(jsolver.graph_chi2)(_jax_graph(), jnp.asarray(rot), jnp.asarray(trans),
                                             jnp.asarray(count)))


@pytest.mark.parametrize("method,preconditioner", [("bcr", "chain"), ("dense", "chain"),
                                                   ("pcg", "chain"), ("pcg", "jacobi")])
def test_solve_pose_graph_matches_reference(method, preconditioner):
    """Each method against the reference's same method; the jacobi
    preconditioner (the reference's too) against the chain one."""
    _, _, est_rot, est_trans, _ = _problem()
    want = _jax_solution(method, "chain")
    got = solver.solve_pose_graph(_port_graph(), T(est_rot), T(est_trans), N, gn_iterations=10,
                                  method=method, preconditioner=preconditioner)
    np.testing.assert_allclose(got.trans.numpy(), np.asarray(want.trans), atol=POSE_TOL)
    np.testing.assert_allclose(got.rot.numpy(), np.asarray(want.rot), atol=POSE_TOL)
    np.testing.assert_array_equal(got.trans.numpy()[N:], est_trans[N:])  # inactive poses fixed
    # chi^2 falls by orders of magnitude from the start and the two agree
    # at the end. (Whether the 1e-9 relative stopping test fires before the
    # iteration cap depends on f32 jitter at the optimum, in both packages.)
    assert float(got.final_error) < 1e-2 * _jax_chi2(est_rot, est_trans)
    assert abs(float(got.final_error) - float(want.final_error)) <= 1e-3 * (
        1.0 + float(want.final_error))


def test_graph_chi2_matches_reference():
    _, _, est_rot, est_trans, _ = _problem()
    want = _jax_chi2(est_rot, est_trans)
    got = float(solver.graph_chi2(_from_jax(_jax_graph()), T(est_rot), T(est_trans), N))
    assert abs(got - want) <= 1e-4 * want


def test_linearization_matches_reference():
    """Residuals and Jacobians of every factor (jax.jacrev there, closed
    form here)."""
    _, _, est_rot, est_trans, _ = _problem()
    want = jax.jit(jsolver._linearize)(_jax_graph(), jnp.asarray(est_rot),
                                       jnp.asarray(est_trans), jnp.asarray(N))
    got = solver._linearize(_port_graph(), T(est_rot), T(est_trans), torch.tensor(N))
    valid = np.asarray(want.valid)
    np.testing.assert_array_equal(got.valid.numpy(), valid)
    for field in ("res", "jac_i", "jac_j", "info_w"):
        g, w = getattr(got, field).numpy()[valid], np.asarray(getattr(want, field))[valid]
        scale = np.abs(w).max() + 1.0
        np.testing.assert_allclose(g / scale, w / scale, atol=1e-5, err_msg=field)


def test_marginal_covariance_matches_reference():
    _, _, est_rot, est_trans, _ = _problem()
    keys = np.array([0, 3, 7, N - 1], np.int32)
    want = np.asarray(jsolver.marginal_covariance(_jax_graph(), jnp.asarray(est_rot),
                                                  jnp.asarray(est_trans), jnp.asarray(N),
                                                  jnp.asarray(keys)))
    got = solver.marginal_covariance(_port_graph(), T(est_rot), T(est_trans), N,
                                     T(keys)).numpy()
    assert got.shape == (len(keys), 6, 6)
    # a Cholesky of H (entries up to 1e6, inactive poses at 1): relative to
    # each block's scale
    scale = np.abs(want).max(axis=(1, 2), keepdims=True)
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-3)


@pytest.mark.parametrize("count", [N - 3, N - 4])
def test_bcr_matches_dense_at_odd_and_masked_counts(count):
    """solver.py's per-level padding path (an odd live count inside a
    power-of-two capacity), against the port's dense solve and JAX's bcr."""
    _, _, est_rot, est_trans, _ = _problem()
    kw = dict(gn_iterations=10)
    g = _port_graph()
    dense = solver.solve_pose_graph(g, T(est_rot), T(est_trans), count, method="dense", **kw)
    bcr = solver.solve_pose_graph(g, T(est_rot), T(est_trans), count, method="bcr", **kw)
    np.testing.assert_allclose(bcr.trans.numpy()[:count], dense.trans.numpy()[:count],
                               atol=1e-4)
    np.testing.assert_array_equal(bcr.trans.numpy()[count:], est_trans[count:])
    want = _jax_solution("bcr", count=count)
    np.testing.assert_allclose(bcr.trans.numpy(), np.asarray(want.trans), atol=POSE_TOL)


@pytest.mark.parametrize("k", [37, 64])
def test_bcr_solve_linear_oracle(k):
    """The tridiagonal solver alone vs a dense f64 solve on a random SPD
    block-tridiagonal system, and vs the reference's _bcr_solve."""
    rng = np.random.default_rng(7)
    a = rng.normal(size=(k, 6, 6)).astype(np.float32)
    d = np.einsum("kij,klj->kil", a, a) + 6.0 * np.eye(6, dtype=np.float32)
    e = 0.3 * rng.normal(size=(k - 1, 6, 6)).astype(np.float32)
    b = rng.normal(size=(k, 6, 3)).astype(np.float32)
    t = np.zeros((k * 6, k * 6))
    for i in range(k):
        t[i * 6:(i + 1) * 6, i * 6:(i + 1) * 6] = d[i]
    for i in range(k - 1):
        t[i * 6:(i + 1) * 6, (i + 1) * 6:(i + 2) * 6] = e[i]
        t[(i + 1) * 6:(i + 2) * 6, i * 6:(i + 1) * 6] = e[i].T
    want = np.linalg.solve(t, b.reshape(k * 6, 3)).reshape(k, 6, 3)
    got = solver._bcr_solve(T(d), T(e), T(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-5)
    ref = np.asarray(jax.jit(jsolver._bcr_solve)(jnp.asarray(d), jnp.asarray(e), jnp.asarray(b)))
    np.testing.assert_allclose(got, ref, rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("scale", [0.0, 1e-6, 1e-2, 0.6, 2.0])
def test_closed_form_jacobians_match_autodiff(scale):
    """The port's closed-form between-factor Jacobians against
    torch.func.jacrev of the same residual (what the reference takes with
    jax.jacrev), in f64, from zero residuals past theta = pi."""
    g = torch.Generator().manual_seed(int(scale * 1e6) + 1)
    f = 64

    def pose():
        xi = torch.cat([torch.randn(f, 3, generator=g), 3 * torch.randn(f, 3, generator=g)], -1)
        return se3_t.exp(xi.double())

    ti, tj = pose(), pose()
    delta = (scale * torch.randn(f, 6, generator=g)).double()
    z = ti.inverse().compose(tj).compose(se3_t.exp(-delta))
    res, ji, jj = solver._res_and_jac(ti.rot, ti.trans, tj.rot, tj.trans, z.rot, z.trans)
    zero = torch.zeros(f, 6, dtype=torch.float64)
    want_i, want_j = torch.func.vmap(torch.func.jacrev(solver._between_residual, argnums=(0, 1)))(
        zero, zero, ti.rot, ti.trans, tj.rot, tj.trans, z.rot, z.trans)
    np.testing.assert_allclose(ji.numpy(), want_i.numpy(), atol=1e-9)
    np.testing.assert_allclose(jj.numpy(), want_j.numpy(), atol=1e-9)
    if scale == 0.0:
        np.testing.assert_allclose(jj.numpy(), np.broadcast_to(np.eye(6), jj.shape), atol=1e-9)


def test_inv3x3_blocks6_matches_reference():
    rng = np.random.default_rng(8)
    a = rng.normal(size=(40, 6, 6)).astype(np.float32)
    m = np.einsum("kij,klj->kil", a, a) + 0.5 * np.eye(6, dtype=np.float32)
    want = np.asarray(jsolver.inv3x3_blocks6(jnp.asarray(m)))
    got = solver.inv3x3_blocks6(T(m)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(np.einsum("kij,kjl->kil", got, m),
                               np.broadcast_to(np.eye(6), m.shape), atol=1e-3)
