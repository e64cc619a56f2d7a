"""The back-end slice as a whole against the JAX reference, at the bag
fixture's capacities: front-end scan_step on every scan, backend_step at the
0.15 s mapping cadence (runtime/slam.py:355-384), then solve_graph_host;
a JAX BackendState carried into the port and stepped once more; the no-op
solve; and the scan-context descriptors the step stores."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import T, jax_config, jax_feature_parts, jax_sim_frames, rot_err_deg, \
    small_config

from rolo_tpu.frontend import odometry as jodo
from rolo_tpu.loop import scancontext as jsc
from rolo_tpu.mapping import backend as jbk
from rolo_tpu.pointcloud.cloud import PaddedCloud as JCloud

from rolo_tpu_torch.frontend import odometry as odo
from rolo_tpu_torch.loop import scancontext as sc
from rolo_tpu_torch.mapping import backend as bk
from rolo_tpu_torch.pointcloud.cloud import PaddedCloud

OVERRIDES = {"mapping.mapping_process_interval": 0.15}  # the default cadence
N_SCANS, DT, K = 7, 0.1, 20
# One mapping step from the same state and inputs: the fixture's 16-beam
# scans leave every step degenerate (the projection drops directions) and the
# f32 plane fits flip a few surface gates (test_torch_mapping.py), which
# measured up to 0.08 deg / 6 mm per step between the packages.
STEP_ROT_DEG, STEP_TRANS_M = 0.15, 0.01
# Four mapping steps fed by each package's own front-end (0.04 deg apart per
# scan here, test_torch_frontend.py holds 0.1 deg / 1 cm) compound those.
MAP_ROT_DEG, MAP_TRANS_M = 0.3, 0.02


@functools.lru_cache(maxsize=None)
def _configs():
    return jax_config(**{k: v for k, v in OVERRIDES.items()}), small_config(**OVERRIDES)


@functools.lru_cache(maxsize=None)
def _jax_front():
    cfg = _configs()[0]
    return jax.jit(lambda s, x, m, dt: jodo.scan_step(s, x, m, dt, cfg.registration,
                                                      cfg.static.max_voxels, K))


def _cadence(n):
    """Indices of the scans at which the mapping cadence fires."""
    last, out = -np.inf, []
    for i in range(n):
        if i * DT - last >= _configs()[0].mapping.mapping_process_interval:
            last = i * DT
            out.append(i)
    return out


@pytest.fixture(scope="module")
def parts():
    return jax_feature_parts(jax_sim_frames(N_SCANS), _configs()[0])


@pytest.fixture(scope="module")
def jax_run(parts):
    """The reference's sequence: states and outputs after each mapping step
    (with the front-end pose that fed it), and the state after the solve."""
    jcfg = _configs()[0]
    front = jodo.init_state(jcfg.static.max_feature_points)
    state = jbk.init_backend(jcfg)
    steps = []
    mapped = set(_cadence(N_SCANS))
    for i, (feat, fc, raw) in enumerate(parts):
        front, fo = _jax_front()(front, jnp.asarray(feat.xyz), jnp.asarray(feat.mask),
                                 jnp.float32(DT))
        if i in mapped:
            inputs = (fc.corners, fc.surfaces, raw, np.asarray(fo.pose_rot),
                      np.asarray(fo.pose_trans), float(i * DT))
            before = state
            state, out = jbk.backend_step(state, *_jax_inputs(*inputs), jcfg)
            steps.append((before, inputs, state, out))
    solved = jbk.solve_graph_host(state, jcfg)
    return steps, solved


def _jax_inputs(corner, surf, raw, rot, trans, stamp):
    c = lambda p: JCloud(jnp.asarray(p.xyz), jnp.asarray(p.mask))  # noqa: E731
    return (c(corner), c(surf), c(raw), jnp.asarray(rot), jnp.asarray(trans), jnp.asarray(True),
            jnp.asarray(stamp, jnp.float32))


def _port_inputs(corner, surf, raw, rot, trans, stamp):
    c = lambda p: PaddedCloud(T(p.xyz), T(p.mask))  # noqa: E731
    return c(corner), c(surf), c(raw), T(rot), T(trans), True, stamp


def _close(rot, trans, jrot, jtrans, rot_deg, trans_m):
    assert rot_err_deg(np.asarray(rot), np.asarray(jrot)) < rot_deg
    assert np.linalg.norm(np.asarray(trans) - np.asarray(jtrans)) < trans_m


def test_sequence_matches_reference(parts, jax_run):
    steps, jsolved = jax_run
    cfg = _configs()[1]
    front = odo.init_state(cfg.static.max_feature_points, "cpu")
    state = bk.init_backend(cfg, "cpu")
    mapped = _cadence(N_SCANS)
    outs = []
    for i, (feat, fc, raw) in enumerate(parts):
        front, fo = odo.scan_step(front, T(feat.xyz), T(feat.mask), DT, cfg.registration,
                                  cfg.static.max_voxels, K)
        if i in mapped:
            state, out = bk.backend_step(state, *_port_inputs(fc.corners, fc.surfaces, raw,
                                                              fo.pose_rot, fo.pose_trans,
                                                              i * DT), cfg)
            outs.append(out)
    assert len(outs) == len(steps) == 4
    for out, (_, _, jstate, jout) in zip(outs, steps):
        _close(out.rot, out.trans, jout.rot, jout.trans, MAP_ROT_DEG, MAP_TRANS_M)
        assert bool(out.keyframe_added) == bool(jout.keyframe_added)
        assert int(out.s2m_iterations) >= 1 or int(jout.s2m_iterations) == 0
    assert int(state.db.count) == int(steps[-1][2].db.count) == 4
    assert int(state.scdb.count) == 4
    # the sensor moved ~2 m and scan2map ran on every step after the first
    assert np.linalg.norm(outs[-1].trans.numpy()) > 1.5
    assert all(int(o.num_factors) >= 50 for o in outs[1:])

    solved = bk.solve_graph_host(state, cfg, count_hint=len(mapped))
    assert not bool(solved.pending_solve)
    n = int(solved.db.count)
    for i in range(n):
        _close(solved.db.rot[i], solved.db.trans[i], jsolved.db.rot[i], jsolved.db.trans[i],
               MAP_ROT_DEG, MAP_TRANS_M)
    _close(so3_matrix(solved.rpy), solved.xyz, so3_matrix(T(jsolved.rpy)), jsolved.xyz,
           MAP_ROT_DEG, MAP_TRANS_M)


def so3_matrix(rpy):
    from rolo_tpu_torch.geometry.so3 import rpy_to_matrix

    return rpy_to_matrix(*torch.as_tensor(np.asarray(rpy))).numpy()


def test_state_carried_from_jax_steps_like_reference(jax_run):
    steps, _ = jax_run
    cfg = _configs()[1]
    before, inputs, jafter, jout = steps[2]
    arrays = bk.backend_state_to_numpy(before)
    state = bk.backend_state_from_numpy(arrays, "cpu")
    back = bk.backend_state_to_numpy(state)
    assert set(back) == set(arrays)
    for key, value in arrays.items():
        assert back[key].shape == value.shape and back[key].dtype == value.dtype, key
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    state, out = bk.backend_step(state, *_port_inputs(*inputs), cfg)
    _close(out.rot, out.trans, jout.rot, jout.trans, STEP_ROT_DEG, STEP_TRANS_M)
    assert bool(out.keyframe_added) == bool(jout.keyframe_added)
    got, want = bk.backend_state_to_numpy(state), bk.backend_state_to_numpy(jafter)
    for key in ("db.count", "scdb.count", "graph.loops.count", "dropped_counts", "has_front"):
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    n = int(want["db.count"])
    np.testing.assert_array_equal(got["db.corner_mask"][:n], want["db.corner_mask"][:n])
    np.testing.assert_allclose(got["graph.odom_rel_trans"][:n], want["graph.odom_rel_trans"][:n],
                               atol=STEP_TRANS_M)
    np.testing.assert_allclose(got["scdb.desc"][:n], want["scdb.desc"][:n], atol=1e-5)


def test_noop_solve_leaves_the_pose(jax_run):
    """`_apply_solution` moves the current pose by the latest keyframe's
    correction solved o old^-1: with the solved poses equal to the stored
    ones, the pose stays to 1e-6."""
    steps, _ = jax_run
    state = bk.backend_state_from_numpy(bk.backend_state_to_numpy(steps[-1][2]), "cpu")
    # move the current pose off the latest keyframe so the delta matters
    state = state._replace(xyz=state.xyz + torch.tensor([0.3, -0.2, 0.05]),
                           rpy=state.rpy + torch.tensor([0.0, 0.0, 0.1]),
                           pending_solve=torch.tensor(True))
    b = 64
    after = bk._apply_solution(state, state.db.rot[:b].clone(), state.db.trans[:b].clone())
    np.testing.assert_allclose(after.xyz.numpy(), state.xyz.numpy(), atol=1e-6)
    np.testing.assert_allclose(after.rpy.numpy(), state.rpy.numpy(), atol=1e-6)
    assert not bool(after.pending_solve)
    # an odometry-only graph solves to itself: the correction stays tiny
    solved = bk.solve_graph_host(state, _configs()[1])
    np.testing.assert_allclose(solved.xyz.numpy(), state.xyz.numpy(), atol=1e-4)


def test_solve_bucket_follows_count_hint(jax_run, monkeypatch):
    steps, _ = jax_run
    state = bk.backend_state_from_numpy(bk.backend_state_to_numpy(steps[-1][2]), "cpu")
    seen = []
    real = bk.solve_pose_graph

    def spy(graph, rot, trans, count, **kw):
        seen.append(rot.shape[0])
        return real(graph, rot, trans, count, **kw)

    monkeypatch.setattr(bk, "solve_pose_graph", spy)
    bk.solve_graph_host(state, count_hint=3)
    bk.solve_graph_host(state, count_hint=65)  # past the 64-slot DB: the capacity
    empty = bk.solve_graph_host(bk.init_backend(_configs()[1], "cpu"), count_hint=0)
    assert seen == [64, 64]
    assert not bool(empty.pending_solve)


def test_scan_context_descriptor_matches_reference(parts):
    jcfg = _configs()[0]
    lc = jcfg.loop
    raw = parts[3][2]
    want = np.asarray(jsc.make_descriptor(jnp.asarray(raw.xyz), jnp.asarray(raw.mask),
                                          lc.sc_num_ring, lc.sc_num_sector, lc.sc_max_radius,
                                          lc.sc_lidar_height))
    got = sc.make_descriptor(T(raw.xyz), T(raw.mask), lc.sc_num_ring, lc.sc_num_sector,
                             lc.sc_max_radius, lc.sc_lidar_height)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want != 0).mean() > 0.2
    db = sc.init_db(2, lc.sc_num_ring, lc.sc_num_sector, "cpu")
    for enable in (True, False, True, True):  # the last add finds the store full
        db = sc.add_descriptor(db, got, enable)
    jdb = jsc.init_db(2, lc.sc_num_ring, lc.sc_num_sector)
    for _ in range(3):
        jdb = jsc.add_descriptor(jdb, jnp.asarray(want))
    for field in sc.ScanContextDB._fields:
        np.testing.assert_allclose(getattr(db, field).numpy(), np.asarray(getattr(jdb, field)),
                                   atol=1e-6, err_msg=field)
