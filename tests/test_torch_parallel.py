"""The port's parallel/ layer in one process (a one-rank gloo group):
mesh helpers and batch slices, registration_batch against the same pairs
one at a time, odometry_batch against each sequence's own run_sequence,
prior_solve_batch against the JAX reference's (tests/test_parallel.py's
scene and limits) and against the scalar solver, the SPMD path's check of
the point count, and distributed_init without a cluster.

A batch gives each instance the bits it gets alone (the batch-invariant
sums of registration/gicp.py and prior/vehicle.py), so those comparisons
are torch.equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import T

from rolo_tpu.config import PriorConfig as JPriorConfig
from rolo_tpu.parallel import prior_solve_batch as jprior_solve_batch
from rolo_tpu.prior import ground as jgnd
from rolo_tpu.prior import vehicle as jveh

from rolo_tpu_torch.config import PriorConfig, RegistrationConfig
from rolo_tpu_torch.frontend.odometry import run_sequence
from rolo_tpu_torch.parallel import (make_mesh, odometry_batch, pad_to_multiple,
                                     prior_solve_batch, registration_batch, shard_batch,
                                     shard_registration_inputs)
from rolo_tpu_torch.parallel import mesh as pmesh
from rolo_tpu_torch.parallel import spmd
from rolo_tpu_torch.prior.ground import GroundMap
from rolo_tpu_torch.prior.vehicle import from_config, solve_pose
from rolo_tpu_torch.registration.rotgicp import register_scan_pair


def _structured(n, seed):
    """tests/test_parallel.py's four noisy walls."""
    rng = np.random.default_rng(seed)
    walls = []
    for nv, d in [((1, 0, 0), 8.0), ((0, 1, 0), 10.0), ((0, 0, 1), -1.5), ((0.7, 0.7, 0), 12.0)]:
        m = n // 4
        nv = np.array(nv, np.float64)
        nv /= np.linalg.norm(nv)
        t1 = np.cross(nv, [0, 0, 1.0] if abs(nv[2]) < 0.9 else [1.0, 0, 0])
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(nv, t1)
        u = rng.uniform(-5, 5, (m, 2))
        walls.append(d * nv + u[:, :1] * t1 + u[:, 1:] * t2)
    pts = np.concatenate(walls)[:n].astype(np.float32)
    return pts + rng.normal(0, 0.005, pts.shape).astype(np.float32)


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(device_type="cpu")


def test_mesh_helpers(mesh):
    assert mesh.mesh_dim_names == ("batch",) and pmesh.axis_size(mesh, "batch") == 1
    grid = make_mesh(1, axis_names=("host", "batch"), axis_sizes=(1, 1), device_type="cpu")
    assert pmesh.axis_size(grid, ("host", "batch")) == 1
    pod = pmesh.make_pod_mesh(device_type="cpu")
    assert pod.mesh_dim_names == ("host", "batch")
    x, y = torch.zeros(16, 4), torch.zeros(3)
    sx, sy = shard_batch((x, y), mesh)
    assert sx.shape == (16, 4) and sy.shape == (3,)  # one rank holds the whole batch
    assert [type(p).__name__ for p in pmesh.batch_sharding(mesh)] == ["Shard"]
    assert [type(p).__name__ for p in pmesh.pod_batch_sharding(pod)] == ["Shard", "Shard"]
    assert [type(p).__name__ for p in pmesh.replicated(pod)] == ["Replicate", "Replicate"]
    with pytest.raises(ValueError):
        make_mesh(8, device_type="cpu")  # a mesh spans the whole (one-rank) group
    with pytest.raises(ValueError):
        make_mesh(1, axis_names=("host", "batch"), device_type="cpu")


@pytest.mark.parametrize("n,m,want", [(0, 8, 0), (1, 8, 8), (8, 8, 8), (9, 8, 16), (100, 3, 102)])
def test_pad_to_multiple(n, m, want):
    assert pad_to_multiple(n, m) == want


def test_distributed_init_single_process_is_a_noop(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    was = torch.distributed.is_initialized()
    assert pmesh.distributed_init() is False
    assert torch.distributed.is_initialized() == was


def _pairs(b=4, n=256):
    src = np.stack([_structured(n, 100 + s) for s in range(b)])
    ang = 0.05
    c, s = np.cos(ang), np.sin(ang)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    tgt = (src @ rot.T + np.array([0.1 * i for i in range(b)], np.float32)[:, None, None]
           * np.float32([1, 0, 0])).astype(np.float32)
    return T(src), T(tgt), torch.ones(b, n, dtype=torch.bool)


def test_registration_batch_matches_single(mesh):
    cfg = RegistrationConfig(max_outer_iterations=8)
    src, tgt, mask = _pairs()
    res = registration_batch(*shard_registration_inputs(mesh, src, mask, tgt, mask), cfg=cfg,
                             voxel_capacity=1024, k=10)
    z, dt = torch.zeros(1, 3), torch.full((1,), 0.1)
    for i in range(src.shape[0]):
        one = register_scan_pair(src[i:i + 1], mask[i:i + 1], tgt[i:i + 1], mask[i:i + 1], z, z,
                                 dt, dt, cfg, 1024, 10)
        for a, b in zip(one, res):
            assert torch.equal(a[0], b[i])


def test_odometry_batch_equals_each_run_sequence():
    """B = 2 sequences of T = 3 scans of 256 points (tests/test_parallel.py's
    moving sensor): each sequence gets its own run_sequence's bits, and the
    sensor's ~0.2 m steps are recovered."""
    b, steps, n = 2, 3, 256
    cfg = RegistrationConfig(max_outer_iterations=8)
    feats = np.zeros((b, steps, n, 3), np.float32)
    for i in range(b):
        base = _structured(n, 200 + i)
        for t in range(steps):
            feats[i, t] = base - np.array([0.2 * t, 0, 0], np.float32)
    masks = torch.ones(b, steps, n, dtype=torch.bool)
    intervals = torch.full((b, steps), 0.1)
    outs = odometry_batch(T(feats), masks, intervals, cfg=cfg, voxel_capacity=1024, k=10)
    assert outs.pose_trans.shape == (b, steps, 3)
    for i in range(b):
        one = run_sequence(T(feats[i]), masks[i], intervals[i], cfg, 1024, 10)
        for a, c in zip(one, outs):
            assert torch.equal(a, c[i])
    np.testing.assert_allclose(outs.pose_trans[:, -1, 0].numpy(), 0.4, atol=0.15)


def _slope_map(n=4096):
    rng = np.random.default_rng(1)
    xy = rng.uniform(-10, 10, (n, 2))
    return np.column_stack([xy, 0.1 * xy[:, 0]]).astype(np.float32)


def test_prior_solve_batch_matches_reference_and_scalar():
    """tests/test_parallel.py's batched solves on a 0.1 slope: every solve
    converges to |pitch| ~ atan(0.1) (that test's limit), z / roll / pitch
    within 1e-4 of the reference's batch (tests/test_torch_prior.py's
    tolerance), and each instance equal to the scalar solver's result."""
    pts = _slope_map()
    b = 8
    xs = np.linspace(-3, 3, b).astype(np.float32)
    jcfg = JPriorConfig(tolerance_roll=0.5, tolerance_pitch=0.5)
    want = jprior_solve_batch(jgnd.GroundMap(jnp.asarray(pts), jnp.ones(len(pts), bool)),
                              jveh.from_config(jcfg), jnp.asarray(xs), jnp.zeros(b),
                              jnp.zeros(b), jcfg)
    cfg = PriorConfig(tolerance_roll=0.5, tolerance_pitch=0.5)
    gm = GroundMap(T(pts), torch.ones(len(pts), dtype=torch.bool))
    vm = from_config(cfg, "cpu")
    got = prior_solve_batch(gm, vm, T(xs), torch.zeros(b), torch.zeros(b), cfg)
    assert bool(got.converged.all()) and bool(jnp.all(want.converged))
    np.testing.assert_allclose(np.abs(got.pitch.numpy()), np.arctan(0.1), atol=0.08)
    for field in ("z", "roll", "pitch"):
        np.testing.assert_allclose(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                   atol=1e-4, err_msg=field)
    np.testing.assert_array_equal(got.success.numpy(), np.asarray(want.success))
    for i in range(b):
        one = solve_pose(gm, vm, float(xs[i]), 0.0, 0.0, cfg)
        for a, c in zip(one, got):
            assert torch.equal(a, c[i])


def test_spmd_rejects_indivisible_point_count(monkeypatch):
    """The count is checked against the group size before any collective
    (here a one-rank group that reports 8 ranks)."""
    make_mesh(device_type="cpu")
    monkeypatch.setattr(spmd.dist, "get_world_size", lambda group=None: 8)
    bad, m = torch.zeros(100, 3), torch.ones(100, dtype=torch.bool)
    with pytest.raises(ValueError):
        spmd.register_scan_pair_spmd(None, bad, m, bad, m, torch.zeros(3), torch.zeros(3), 0.1,
                                     0.1)
