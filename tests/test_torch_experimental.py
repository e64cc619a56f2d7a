"""The port's Gauss-Newton SE(3) and multi-point GICP
(rolo_tpu_torch/registration/experimental.py) on tests/test_experimental.py's
three cases, and register_multipoint against the JAX reference on the same
problem, held to tests/test_torch_registration.py's package tolerance,
0.05° / 0.005 m."""

import jax.numpy as jnp
import numpy as np
import torch

from test_experimental import transform_pts
from test_registration import make_scene
from torch_parity import T, rot_err_deg

from rolo_tpu.registration import experimental as jexperimental

from rolo_tpu_torch.registration import experimental, gicp, lm
from rolo_tpu_torch.voxel.knn import estimate_cov6
from rolo_tpu_torch.voxel.voxelmap import build_voxel_map

POLAR = (0.175, 0.175, 2.0)
POSE_ROT_DEG, POSE_TRANS_M = 0.05, 0.005


def _cloud(pts):
    return T(pts)[None], torch.ones(1, len(pts), dtype=torch.bool)


def _start():
    return torch.eye(3)[None], torch.zeros(1, 3)


def test_gauss_newton_recovers_se3():
    pts = make_scene(1024, seed=11)
    t = [0.3, -0.2, 0.1]
    moved, rot_true = transform_pts(pts, [0.02, -0.015, 0.03], t)
    src, mask = _cloud(pts)
    tgt, _ = _cloud(moved)
    src_cov, tgt_cov = estimate_cov6(src, mask, k=10), estimate_cov6(tgt, mask, k=10)
    vm = build_voxel_map(tgt, tgt_cov, mask, 2048, polar_res=POLAR)
    ctx = gicp.make_context(src, mask, src_cov, vm, polar_res=POLAR)
    res = lm.gn_register_se3(ctx, *_start())
    assert bool(res.converged[0])
    np.testing.assert_allclose(res.rot[0].numpy(), rot_true, atol=5e-3)
    np.testing.assert_allclose(res.trans[0].numpy(), t, atol=5e-2)


def _multipoint_case():
    pts = make_scene(1024, seed=5)
    t = [0.25, 0.15, -0.1]
    moved, rot_true = transform_pts(pts, [0.015, 0.01, -0.025], t)
    return pts, moved.astype(np.float32), rot_true, t


def test_multipoint_recovers_se3():
    pts, moved, rot_true, t = _multipoint_case()
    prob = experimental.make_problem(*_cloud(pts), *_cloud(moved), k_cov=10)
    res = experimental.register_multipoint(prob, *_start(), k=4)
    assert bool(res.converged[0])
    np.testing.assert_allclose(res.rot[0].numpy(), rot_true, atol=5e-3)
    np.testing.assert_allclose(res.trans[0].numpy(), t, atol=5e-2)


def test_masks_far_neighbors():
    """At the identity each point's nearest neighbour is itself (d = 0);
    every other neighbour lies beyond 1e-3 and is masked."""
    pts = make_scene(512, seed=9)
    prob = experimental.make_problem(*_cloud(pts), *_cloud(pts), k_cov=10)
    corr = experimental._bind_multipoint(prob, *_start(), k=4, max_dist=1e-3)
    assert int((corr.weight[0] > 0).sum(dim=0).max()) <= 1


def test_register_multipoint_matches_reference():
    """k = 8 neighbours, each package from its own covariances."""
    pts, moved, _, _ = _multipoint_case()
    mask = jnp.ones(len(pts), bool)
    jprob = jexperimental.make_problem(jnp.asarray(pts), mask, jnp.asarray(moved), mask, k_cov=10)
    want = jexperimental.register_multipoint(jprob, jnp.eye(3, dtype=jnp.float32),
                                             jnp.zeros(3, jnp.float32), k=8)
    prob = experimental.make_problem(*_cloud(pts), *_cloud(moved), k_cov=10)
    got = experimental.register_multipoint(prob, *_start(), k=8)
    assert bool(got.converged[0]) == bool(want.converged)
    assert float(rot_err_deg(got.rot[0].numpy(), np.asarray(want.rot))) < POSE_ROT_DEG
    assert float(np.linalg.norm(got.trans[0].numpy() - np.asarray(want.trans))) < POSE_TRANS_M
