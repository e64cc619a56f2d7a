"""The port's SE(3) registration surface and objective hooks against the
JAX reference: gicp.se3_linearize, lm.lm_register_se3 / gn_register_se3
and rotgicp.register_se3 on tests/test_experimental.py's scene (1,024
points, k = 10, voxel capacity 2,048), a batch of two against each instance
alone, the hooks given their defaults against no hooks, and estimate_cov6
with a candidate set larger than the queries.

Poses are held to tests/test_torch_registration.py's package tolerance,
0.05° / 0.005 m; linearizations to 1e-5 of their largest entry."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_experimental import transform_pts
from test_registration import make_scene
from torch_parity import T, rot_err_deg

from rolo_tpu.config import RegistrationConfig as JRegistrationConfig
from rolo_tpu.registration import gicp as jgicp
from rolo_tpu.registration import lm as jlm
from rolo_tpu.registration.rotgicp import register_se3 as jregister_se3
from rolo_tpu.voxel import knn as jknn
from rolo_tpu.voxel.voxelmap import build_voxel_map as jbuild_voxel_map

from rolo_tpu_torch.config import RegistrationConfig
from rolo_tpu_torch.geometry import so3
from rolo_tpu_torch.registration import gicp, lm
from rolo_tpu_torch.registration.rotgicp import register_se3
from rolo_tpu_torch.voxel import knn
from rolo_tpu_torch.voxel.voxelmap import build_voxel_map

N, K, CAP = 1024, 10, 2048
POLAR = (0.175, 0.175, 2.0)
POSE_ROT_DEG, POSE_TRANS_M = 0.05, 0.005
LIN_REL = 1e-5
MOTIONS = [([0.02, -0.015, 0.03], [0.3, -0.2, 0.1]), ([-0.01, 0.02, -0.025], [-0.2, 0.15, 0.05])]


@functools.lru_cache(maxsize=None)
def scene(i=0):
    """(src, tgt, rot_true, t_true) as numpy, test_experimental's GN scene
    for i = 0 and a second motion of the same points for i = 1."""
    pts = make_scene(N, seed=11)
    moved, rot = transform_pts(pts, *MOTIONS[i])
    return pts, moved.astype(np.float32), rot, np.asarray(MOTIONS[i][1], np.float32)


@functools.lru_cache(maxsize=None)
def jax_covs(i=0):
    src, tgt, _, _ = scene(i)
    mask = jnp.ones(N, bool)
    return (np.asarray(jknn.estimate_cov6(jnp.asarray(src), mask, k=K)),
            np.asarray(jknn.estimate_cov6(jnp.asarray(tgt), mask, k=K)))


def _jax_ctx(i=0):
    src, tgt, _, _ = scene(i)
    scov, tcov = jax_covs(i)
    mask = jnp.ones(N, bool)
    polar = jnp.asarray(POLAR, jnp.float32)
    vm = jbuild_voxel_map(jnp.asarray(tgt), jnp.asarray(tcov), mask, CAP, polar_res=polar)
    return jgicp.make_context(jnp.asarray(src), mask, jnp.asarray(scov), vm, polar_res=polar)


def _ctx(idx=(0,)):
    """The port's batched context on the JAX covariances of scenes idx."""
    src = torch.stack([T(scene(i)[0]) for i in idx])
    tgt = torch.stack([T(scene(i)[1]) for i in idx])
    scov = torch.stack([T(jax_covs(i)[0]) for i in idx])
    tcov = torch.stack([T(jax_covs(i)[1]) for i in idx])
    mask = torch.ones(len(idx), N, dtype=torch.bool)
    vm = build_voxel_map(tgt, tcov, mask, CAP, polar_res=POLAR)
    return gicp.make_context(src, mask, scov, vm, polar_res=POLAR)


def _close_rel(got, want, rel=LIN_REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * max(1e-30, np.abs(want).max()))


def test_se3_linearize_matches_reference():
    rvec, t = np.float32([0.015, -0.01, 0.02]), np.float32([0.25, -0.15, 0.05])
    jctx = _jax_ctx()
    jrot = jnp.asarray(np.asarray(so3.exp(T(rvec))))
    jcorr = jgicp.update_correspondences(jctx, jrot, jnp.asarray(t))
    jerr, jh, jb = jgicp.se3_linearize(jctx, jcorr, jrot, jnp.asarray(t))
    ctx = _ctx()
    rot = so3.exp(T(rvec))[None]
    corr = gicp.update_correspondences(ctx, rot, T(t)[None])
    err, h, b = gicp.se3_linearize(ctx, corr, rot, T(t)[None])
    _close_rel(err[0], jerr)
    _close_rel(h[0], jh)
    _close_rel(b[0], jb)


def _pose_close(rot, trans, jrot, jtrans):
    assert float(rot_err_deg(rot, np.asarray(jrot))) < POSE_ROT_DEG
    assert float(np.linalg.norm(np.asarray(trans) - np.asarray(jtrans))) < POSE_TRANS_M


def _recovers(res, i=0):
    _, _, rot_true, t_true = scene(i)
    assert bool(res.converged[0])
    np.testing.assert_allclose(res.rot[0].numpy(), rot_true, atol=5e-3)
    np.testing.assert_allclose(res.trans[0].numpy(), t_true, atol=5e-2)


@pytest.mark.parametrize("solver", ["lm", "gn"])
def test_se3_solvers_match_reference(solver):
    """From the identity on the same covariances and map: the reference's
    pose within the package tolerance, and the applied motion recovered to
    tests/test_experimental.py's limits."""
    eye, zero = jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32)
    if solver == "lm":
        want = jlm.lm_register_se3(_jax_ctx(), eye, zero)
        got = lm.lm_register_se3(_ctx(), torch.eye(3)[None], torch.zeros(1, 3))
    else:
        want = jlm.gn_register_se3(_jax_ctx(), eye, zero)
        got = lm.gn_register_se3(_ctx(), torch.eye(3)[None], torch.zeros(1, 3))
    _pose_close(got.rot[0].numpy(), got.trans[0].numpy(), want.rot, want.trans)
    assert bool(got.converged[0]) == bool(want.converged)
    _recovers(got)


def _register_se3(idx):
    src = torch.stack([T(scene(i)[0]) for i in idx])
    tgt = torch.stack([T(scene(i)[1]) for i in idx])
    mask = torch.ones(len(idx), N, dtype=torch.bool)
    eye = torch.eye(3).expand(len(idx), 3, 3)
    return register_se3(src, mask, tgt, mask, eye, torch.zeros(len(idx), 3),
                        RegistrationConfig(), CAP, K)


def test_register_se3_matches_reference():
    """Each package end to end: its own covariances (K2's plain version
    here), its own map, SE(3) LM from the identity."""
    src, tgt, _, _ = scene(0)
    mask = jnp.ones(N, bool)
    want = jregister_se3(jnp.asarray(src), mask, jnp.asarray(tgt), mask,
                         jnp.eye(3, dtype=jnp.float32), jnp.zeros(3, jnp.float32),
                         JRegistrationConfig(), CAP, K)
    got = _register_se3((0,))
    _pose_close(got.rot[0].numpy(), got.trans[0].numpy(), want.rot, want.trans)
    _recovers(got)


def test_register_se3_batch_equals_per_instance():
    """A batch of two pairs gives each pair's own bits: instances that
    stopped keep their state through the masked loop."""
    both = _register_se3((0, 1))
    for i in range(2):
        one = _register_se3((i,))
        for field in ("rot", "trans", "error", "iterations", "converged"):
            assert torch.equal(getattr(one, field)[0], getattr(both, field)[i]), field
    _recovers(_register_se3((1,)), 1)


def test_rotation_hooks_with_defaults_are_bit_equal():
    ctx = _ctx()
    args = (ctx, torch.eye(3)[None], torch.zeros(1, 3))
    plain = lm.lm_register_rotation(*args)
    hooked = lm.lm_register_rotation(*args, linearize_fn=gicp.so3_linearize,
                                     error_fn=gicp.compute_error)
    for a, b in zip(plain, hooked):
        assert torch.equal(a, b)


def test_ct_hooks_and_count_override_are_bit_equal():
    """The CT solvers with hooks that pass the local correspondence count
    as n_corr_override give the bits of the solvers without hooks."""
    ctx = _ctx()

    def n_corr(corr):
        return torch.clamp(gicp.ct_n_corr(corr).to(torch.float32), min=1.0)

    def lin(c, corr, *args):
        return gicp.ct_linearize(c, corr, *args, n_corr_override=n_corr(corr))

    def err(c, corr, *args):
        return gicp.ct_error(c, corr, *args, n_corr_override=n_corr(corr))

    z, dt = torch.zeros(1, 3), torch.full((1,), 0.1)
    args = (ctx, torch.eye(3)[None], T(scene(0)[3])[None] * 0.5, z, z, dt, dt, 0.01)
    plain = lm.lm_translation_rebind(*args, rebind_rounds=2)
    hooked = lm.lm_translation_rebind(*args, rebind_rounds=2, ct_linearize_fn=lin,
                                      ct_error_fn=err)
    for a, b in zip(plain, hooked):
        assert torch.equal(a, b)


def _cand_case():
    """Queries: every other point of the scene's first 512; candidates: the
    whole scene with a few masked slots (NaN padding in one)."""
    src = scene(0)[0].copy()
    cmask = np.ones(N, bool)
    cmask[[7, 300, 901]] = False
    src[901] = np.nan
    q = np.where(cmask[:, None], src, 0.0)[:512:2].astype(np.float32)
    qmask = cmask[:512:2].copy()
    return q, qmask, src, cmask


@pytest.mark.parametrize("selector", ["exact", "moment"])
def test_estimate_cov6_candidates_superset_matches_reference(selector):
    q, qmask, cand, cmask = _cand_case()
    want = np.asarray(jknn.estimate_cov6(jnp.asarray(q), jnp.asarray(qmask), k=K,
                                         selector=selector, cand_xyz=jnp.asarray(cand),
                                         cand_mask=jnp.asarray(cmask)))
    got = knn.estimate_cov6(T(q)[None], T(qmask)[None], k=K, selector=selector,
                            cand_xyz=T(cand)[None], cand_mask=T(cmask)[None])[0].numpy()
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got[:, ~qmask], want[:, ~qmask])
    if selector == "exact":  # the same neighbours: tests/test_torch_voxel.py's tolerance
        np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    else:  # the bisection's membership: the same share as the kernel-composition test
        close = np.all(np.abs(got - want) < 1e-3, axis=0)
        assert close[qmask].mean() > 0.97
