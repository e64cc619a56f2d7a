"""Parity of the port's front-end odometry with the JAX reference: three
scan_steps from the initial state, and a state carried over from the JAX
package after two steps (state_from_numpy) that gives the same third pose."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import T, jax_config, jax_features, jax_sim_frames, rot_err_deg, small_config

from rolo_tpu.frontend import odometry as jodo

from rolo_tpu_torch.frontend.odometry import (OdometryState, init_state, run_sequence, scan_step,
                                              state_from_numpy, state_to_numpy)

K = 20
DT = 0.1  # consecutive scans
# Accumulated-pose agreement after up to three steps (see
# test_torch_registration.py for the per-step sources of difference).
POSE_ROT_DEG = 0.1
POSE_TRANS_M = 0.01


@functools.lru_cache(maxsize=None)
def _jax_step():
    cfg = jax_config()
    return jax.jit(lambda s, x, m, dt: jodo.scan_step(s, x, m, dt, cfg.registration,
                                                      cfg.static.max_voxels, K))


@pytest.fixture(scope="module")
def feats():
    return jax_features(jax_sim_frames(3), jax_config())


@pytest.fixture(scope="module")
def jax_run(feats):
    xyz, mask = feats
    state = jodo.init_state(xyz.shape[1])
    states, outs = [], []
    for i in range(3):
        state, out = _jax_step()(state, jnp.asarray(xyz[i]), jnp.asarray(mask[i]),
                                 jnp.float32(DT))
        states.append(state)
        outs.append(out)
    return states, outs


def _close(rot, trans, jrot, jtrans):
    assert rot_err_deg(rot, np.asarray(jrot)) < POSE_ROT_DEG
    assert np.linalg.norm(np.asarray(trans) - np.asarray(jtrans)) < POSE_TRANS_M


def test_scan_step_sequence_matches_reference(feats, jax_run):
    xyz, mask = feats
    cfg = small_config()
    out = run_sequence(T(xyz), T(mask), torch.full((3,), DT), cfg.registration,
                       cfg.static.max_voxels, K)
    _, jouts = jax_run
    for i in range(3):
        _close(out.pose_rot[i].numpy(), out.pose_trans[i].numpy(), jouts[i].pose_rot,
               jouts[i].pose_trans)
        assert bool(out.failure[i]) == bool(jouts[i].failure)
    assert np.linalg.norm(out.pose_trans[2].numpy()) > 0.5  # the sensor moved ~1 m


def test_state_carried_from_jax_gives_same_third_pose(feats, jax_run):
    xyz, mask = feats
    cfg = small_config()
    jstates, jouts = jax_run
    state = state_from_numpy(jstates[1]._asdict(), "cpu")
    state, out = scan_step(state, T(xyz[2]), T(mask[2]), DT, cfg.registration,
                           cfg.static.max_voxels, K)
    _close(out.pose_rot.numpy(), out.pose_trans.numpy(), jouts[2].pose_rot, jouts[2].pose_trans)
    back = state_to_numpy(state)
    assert set(back) == set(jodo.OdometryState._fields)
    for f in OdometryState._fields:
        assert back[f].shape == np.asarray(getattr(jstates[2], f)).shape, f
        assert back[f].dtype == np.asarray(getattr(jstates[2], f)).dtype, f


def test_init_state_matches_reference():
    j = jodo.init_state(64)
    t = init_state(64, "cpu")
    for f in OdometryState._fields:
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)))
