"""The port's generic manifold EKF (rolo_tpu_torch/filter/manifold.py)
against the JAX reference, on tests/test_manifold.py's cases: the Vect / SO3
/ S2 round trips, the composite round trip, predict and update parity with
the reference's generic filter and with the port's specialized pose ESKF,
and the S2 gravity filter converging.

Between the packages the tolerance is 1e-5 (absolute on unit-scale values,
relative on the covariances); against the specialized filter, the
reference test's own tolerances (a fixed gain against an iterated one)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import T

from rolo_tpu.config import FilterConfig
from rolo_tpu.filter import manifold as jmf
from rolo_tpu.geometry import so3 as jso3

from rolo_tpu_torch.filter import eskf, manifold as mf
from rolo_tpu_torch.geometry import so3

TOL = 1e-5


def _np(x):
    return np.asarray(x, np.float32)


def _unit(v):
    return (v / np.linalg.norm(v)).astype(np.float32)


MANIFOLDS = {
    "vect": (lambda: (mf.Vect(3), jmf.Vect(3)), lambda r: r.normal(size=3).astype(np.float32), 3),
    "so3": (lambda: (mf.SO3(), jmf.SO3()),
            lambda r: _np(jso3.exp(jnp.asarray(r.normal(size=3) * 0.5, jnp.float32))), 3),
    "s2": (lambda: (mf.S2(), jmf.S2()), lambda r: _unit(r.normal(size=3)), 2),
}


@pytest.mark.parametrize("name", list(MANIFOLDS))
def test_boxplus_boxminus_roundtrip(name):
    make, make_x, dim = MANIFOLDS[name]
    m, jm = make()
    r = np.random.default_rng(0)
    for _ in range(5):
        x = make_x(r)
        dx = (r.normal(size=dim) * 0.2).astype(np.float32)
        y = m.boxplus(T(x), T(dx))
        back = m.boxminus(y, T(x))
        np.testing.assert_allclose(back.numpy(), dx, atol=1e-4)
        np.testing.assert_allclose(m.boxplus(T(x), back).numpy(), y.numpy(), atol=1e-5)
        jy = jm.boxplus(jnp.asarray(x), jnp.asarray(dx))
        np.testing.assert_allclose(y.numpy(), _np(jy), atol=TOL)
        np.testing.assert_allclose(back.numpy(), _np(jm.boxminus(jy, jnp.asarray(x))), atol=TOL)


def test_composite_roundtrip():
    decl = [("p", mf.Vect(3)), ("r", mf.SO3()), ("g", mf.S2())]
    jdecl = [("p", jmf.Vect(3)), ("r", jmf.SO3()), ("g", jmf.S2())]
    rng = np.random.default_rng(1)
    x = {"p": rng.normal(size=3).astype(np.float32),
         "r": _np(jso3.exp(jnp.asarray(rng.normal(size=3) * 0.3, jnp.float32))),
         "g": np.array([0.0, 0.0, 1.0], np.float32)}
    assert mf.tangent_dim(decl) == 8
    dx = (rng.normal(size=8) * 0.1).astype(np.float32)
    y = mf.boxplus(decl, {k: T(v) for k, v in x.items()}, T(dx))
    back = mf.boxminus(decl, y, {k: T(v) for k, v in x.items()})
    np.testing.assert_allclose(back.numpy(), dx, atol=1e-4)
    jy = jmf.boxplus(jdecl, {k: jnp.asarray(v) for k, v in x.items()}, jnp.asarray(dx))
    for k in x:
        np.testing.assert_allclose(y[k].numpy(), _np(jy[k]), atol=TOL)


POSE = [("pos", 3), ("rot", None), ("vel", 3), ("omega", 3), ("acc", 3), ("alpha", 3)]


def _decl(m):
    return [(name, m.SO3() if n is None else m.Vect(n)) for name, n in POSE]


def _process(so3_mod):
    def process(x, dt):
        rot_vec = dt * (x["omega"] + 0.5 * dt * x["alpha"])
        return {"pos": x["pos"] + dt * (x["vel"] + 0.5 * dt * x["acc"]),
                "rot": x["rot"] @ so3_mod.exp(rot_vec), "vel": x["vel"] + dt * x["acc"],
                "omega": x["omega"] + dt * x["alpha"], "acc": x["acc"], "alpha": x["alpha"]}
    return process


def _ekf(m, so3_mod):
    return m.GenericEKF(decl=_decl(m), process=_process(so3_mod),
                        measure=lambda x: {"pos": x["pos"], "rot": x["rot"]},
                        meas_decl=[("pos", m.Vect(3)), ("rot", m.SO3())])


def _rand_state(seed):
    """tests/test_manifold.py's random pose state, as numpy, with the port's
    ESKF state holding the same values."""
    rng = np.random.default_rng(seed)
    x = {"pos": rng.normal(size=3), "rot": _np(jso3.exp(jnp.asarray(rng.normal(size=3) * 0.4,
                                                                     jnp.float32))),
         "vel": rng.normal(size=3), "omega": rng.normal(size=3) * 0.5,
         "acc": rng.normal(size=3) * 0.3, "alpha": rng.normal(size=3) * 0.2}
    x = {k: np.asarray(v, np.float32) for k, v in x.items()}
    cfg = FilterConfig()
    st = eskf.init_filter(cfg, "cpu")._replace(
        **{k: T(v) for k, v in x.items()}, initialized=torch.tensor(True))
    return x, st, cfg


def _close_rel(got, want, tol=TOL):
    np.testing.assert_allclose(got, want, atol=tol * max(1.0, float(np.abs(want).max())))


def test_predict_parity():
    """F by forward-mode autodiff through boxminus: the same mean and
    covariance as the reference's generic filter, and as the port's
    hand-coded process Jacobian (filter/eskf.py) given the same Q."""
    x, st, cfg = _rand_state(2)
    dt = 0.1
    qlin = (dt * cfg.q_linear_jerk_std) ** 2
    qang = (dt * cfg.q_angular_jerk_std) ** 2
    q = np.diag(np.r_[np.zeros(12), np.full(3, qlin), np.full(3, qang)]).astype(np.float32)
    p0 = st.cov.numpy()

    got_x, got_p = mf.predict(_ekf(mf, so3), {k: T(v) for k, v in x.items()}, T(p0), T(q), dt)
    want_x, want_p = jmf.predict(_ekf(jmf, jso3), {k: jnp.asarray(v) for k, v in x.items()},
                                 jnp.asarray(p0), jnp.asarray(q), dt)
    for k in x:
        np.testing.assert_allclose(got_x[k].numpy(), _np(want_x[k]), atol=TOL)
    _close_rel(got_p.numpy(), _np(want_p))

    ref = eskf.predict(st, dt, cfg)
    np.testing.assert_allclose(got_x["pos"].numpy(), ref.pos.numpy(), atol=1e-5)
    np.testing.assert_allclose(got_x["rot"].numpy(), ref.rot.numpy(), atol=1e-5)
    np.testing.assert_allclose(got_p.numpy(), ref.cov.numpy(), rtol=2e-2, atol=2e-4)


def test_update_parity():
    """The iterated generic update against the reference's generic update,
    and against the port's specialized fixed-gain update (H = [I6 | 0] is
    state-independent, so both reach the same state)."""
    x, st, cfg = _rand_state(3)
    rng = np.random.default_rng(4)
    z_pos = (x["pos"] + rng.normal(size=3) * 0.3).astype(np.float32)
    z_rot = x["rot"] @ _np(jso3.exp(jnp.asarray(rng.normal(size=3) * 0.1, jnp.float32)))
    r = np.diag(np.r_[np.full(3, cfg.r_position_std ** 2),
                      np.full(3, cfg.r_rotation_std ** 2)]).astype(np.float32)
    p0 = st.cov.numpy()

    got_x, got_p = mf.update_iterated(_ekf(mf, so3), {k: T(v) for k, v in x.items()}, T(p0),
                                      {"pos": T(z_pos), "rot": T(z_rot)}, T(r),
                                      iterations=cfg.maximum_iteration)
    want_x, want_p = jmf.update_iterated(
        _ekf(jmf, jso3), {k: jnp.asarray(v) for k, v in x.items()}, jnp.asarray(p0),
        {"pos": jnp.asarray(z_pos), "rot": jnp.asarray(z_rot)}, jnp.asarray(r),
        iterations=cfg.maximum_iteration)
    for k in x:
        np.testing.assert_allclose(got_x[k].numpy(), _np(want_x[k]), atol=TOL)
    _close_rel(got_p.numpy(), _np(want_p))

    ref = eskf.update_iterated(st, T(z_pos), T(z_rot), cfg)
    np.testing.assert_allclose(got_x["pos"].numpy(), ref.pos.numpy(), atol=2e-3)
    assert float(torch.linalg.vector_norm(so3.log(got_x["rot"].T @ ref.rot))) < 2e-3
    np.testing.assert_allclose(got_p.numpy(), ref.cov.numpy(), rtol=5e-2, atol=5e-4)


def _gravity_run(m, to, ident):
    """tests/test_manifold.py's S2 filter: a unit direction from 25 noisy
    direction measurements; `to` makes the package's arrays."""
    decl = [("g", m.S2())]
    ekf = m.GenericEKF(decl=decl, process=lambda x, dt: x, measure=lambda x: {"g": x["g"]},
                       meas_decl=[("g", m.S2())])
    truth = _unit(np.array([0.3, -0.4, 0.866]))
    x = {"g": to(np.array([0.0, 0.0, 1.0], np.float32))}
    p, q, r = to(ident), to(ident * 1e-6), to(ident * 0.05)
    rng = np.random.default_rng(5)
    for _ in range(25):
        x, p = m.predict(ekf, x, p, q, 0.1)
        zv = _unit(truth + rng.normal(size=3).astype(np.float32) * 0.05)
        x, p = m.update_iterated(ekf, x, p, {"g": to(zv)}, r, iterations=2)
    return _np(x["g"]), _np(p), truth


def test_gravity_direction_converges():
    """A filter the specialized code cannot express: S2 direction
    estimation. The port converges as the reference does and ends within
    1e-5 of it."""
    ident = np.eye(2, dtype=np.float32)
    g, p, truth = _gravity_run(mf, T, ident)
    jg, jp, _ = _gravity_run(jmf, jnp.asarray, ident)
    err = float(np.degrees(np.arccos(np.clip(np.dot(g, truth), -1, 1))))
    assert err < 3.0, err
    assert float(np.trace(p)) < 0.1
    np.testing.assert_allclose(g, jg, atol=TOL)
    _close_rel(p, jp)


def test_jacobians_finite_at_zero_tangent():
    """jacfwd at dx = 0 passes through so3.exp's clamp, so3.log's and S2's
    small-angle branches: every Jacobian entry is finite, and the identity
    process has the identity F."""
    decl = [("r", mf.SO3()), ("g", mf.S2()), ("v", mf.Vect(2))]
    x = {"r": torch.eye(3), "g": torch.tensor([0.0, 0.6, 0.8]), "v": torch.zeros(2)}
    jac = mf._jac_through_boxminus(decl, decl, lambda s: s, x)
    assert torch.isfinite(jac).all()
    torch.testing.assert_close(jac, torch.eye(7), atol=1e-6, rtol=0)
