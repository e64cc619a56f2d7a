"""The third slice as a whole against the JAX reference: on the unit-scale
out-and-back world (keyframes built with add_keyframe, drifting 3 cm per
keyframe), one loop_closure_step, one prior cycle (future pose from the
fused ESKF, contact solve, record_prior_observation, prior_step) and
solve_graph_host run in both packages from the same state. They must accept
the same loop and prior factors (i, j) and end with keyframe poses within
the ICP tolerance."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

from torch_parity import T, out_and_back, port_config, rot_diff_rad
from test_backend import SMALL

from rolo_tpu.config import PriorConfig as JPriorConfig
from rolo_tpu.filter import fusion as jfusion
from rolo_tpu.geometry import so3 as jso3
from rolo_tpu.mapping import backend as jbk
from rolo_tpu.prior import association as jas
from rolo_tpu.prior import ground as jgr
from rolo_tpu.prior import vehicle as jve

from rolo_tpu_torch.filter import fusion
from rolo_tpu_torch.mapping import backend as bk
from rolo_tpu_torch.prior import ground as gr
from rolo_tpu_torch.prior import vehicle as ve
from rolo_tpu_torch.runtime.cycles import prior_cycle

# final keyframe poses between the packages: the loop ICP's tolerance
# (test_torch_loop.py), carried through one graph solve
POSE_TRANS_M, POSE_ROT_RAD = 1e-3, 1e-3
GROUND_Z = -1.5  # the structured world's ground plane (tests/test_backend.py:52)


def _ground():
    rng = np.random.default_rng(0)
    xy = rng.uniform(-12, 12, (8192, 2))
    z = GROUND_Z + rng.normal(0, 0.005, 8192)
    return np.column_stack([xy, z]).astype(np.float32)


def _config():
    return dataclasses.replace(
        SMALL, loop=dataclasses.replace(SMALL.loop, loop_close_type="all"),
        prior=JPriorConfig(near_prior_radius=2.0, fitness_score=0.05, tolerance_roll=0.5,
                           tolerance_pitch=0.5))


def _jax_start(cfg, gm):
    """The out-and-back state with one stored prior at (1, 0) linked to
    keyframe 1, and a fusion state fed the keyframe poses at 1 Hz with the
    last mapping pose recorded."""
    state = out_and_back(cfg)
    obs = jas.compute_prior(gm, jve.from_config(cfg.prior), jnp.float32(1.0), jnp.float32(0.0),
                            jnp.float32(np.pi), cfg.prior, state.prior_queue.patch_xyz.shape[1])
    assert bool(obs.success)
    q = jas.push_prior(state.prior_queue, obs, jnp.asarray(1), state.db.rot[1], state.db.trans[1])
    fs = jfusion.init_fusion(cfg.filter)
    n = int(state.db.count)
    for i in range(n):
        fs, _ = jfusion.on_front_odometry(fs, jnp.float32(i), state.db.rot[i], state.db.trans[i],
                                          cfg.filter)
    fs = jfusion.on_mapping_odometry(fs, state.db.rot[n - 1], state.db.trans[n - 1],
                                     state.db.rot[n - 1], state.db.trans[n - 1])
    return state._replace(prior_queue=q), fs


def _jax_prior_cycle(fs, stamp, state, gm, vehicle, cfg):
    """runtime/slam.py's _prior_cycle_jit (slam.py:228-252), step by step."""
    fut = jfusion.predict_future(fs, cfg.filter)
    fused = jfusion.fused_pose(fs, stamp, cfg.filter)
    world_pos = fused.rot @ fut.final_pos + fused.trans
    world_rot = fused.rot @ jso3.quat_to_matrix(fut.final_quat)
    yaw = jnp.arctan2(world_rot[1, 0], world_rot[0, 0])
    obs = jas.compute_prior(gm, vehicle, world_pos[0], world_pos[1], yaw, cfg.prior, 2048)
    obs = obs._replace(success=obs.success & fut.valid & fused.valid)
    state = jbk.record_prior_observation(state, obs, obs_time=stamp, cfg=cfg)
    patch = jgr.extract_patch(gm, state.xyz[:2], 4.0 * cfg.prior.ground_patch_size, 4096)
    return jbk.prior_step(state, patch, cfg)


def _factors(between):
    return [(int(between.i[k]), int(between.j[k])) for k in range(int(between.count))]


def test_loop_prior_and_solve_match_reference():
    cfg = _config()
    pcfg = port_config(cfg)
    pts = _ground()
    jgm = jgr.GroundMap(jnp.asarray(pts), jnp.ones(len(pts), bool))
    gm = gr.GroundMap(T(pts), torch.ones(len(pts), dtype=torch.bool))
    jstate, jfs = _jax_start(cfg, jgm)
    state = bk.backend_state_from_numpy(bk.backend_state_to_numpy(jstate), "cpu")
    fs = fusion.fusion_state_from_numpy(fusion.fusion_state_to_numpy(jfs), "cpu")
    stamp = 13.0  # the latest keyframe's stamp: the 10 ms sync gate passes

    jstate, jclosed = jbk.loop_closure_step(jstate, cfg)
    jstate, jmatched = _jax_prior_cycle(jfs, jnp.float32(stamp), jstate, jgm,
                                        jve.from_config(cfg.prior), cfg)
    jsolved = jbk.solve_graph_host(jstate, cfg)

    state, closed = bk.loop_closure_step(state, pcfg)
    state, matched = prior_cycle(fs, stamp, state, gm, ve.from_config(pcfg.prior, "cpu"), pcfg)
    solved = bk.solve_graph_host(state, pcfg)

    assert bool(closed) == bool(jclosed) and bool(matched) == bool(jmatched)
    assert _factors(state.graph.loops) == _factors(jstate.graph.loops) == [(13, 0)]
    assert _factors(state.graph.priors) == _factors(jstate.graph.priors) == [(1, 13)]
    # the cycle also recorded this tick's observation, linked to keyframe 13
    assert int(state.prior_queue.count) == int(jstate.prior_queue.count) == 2
    np.testing.assert_array_equal(state.prior_queue.linked_key.numpy(),
                                  np.asarray(jstate.prior_queue.linked_key))
    assert not bool(solved.pending_solve) and not bool(jsolved.pending_solve)
    n = int(solved.db.count)
    got_t, want_t = solved.db.trans[:n].numpy(), np.asarray(jsolved.db.trans[:n])
    assert np.abs(got_t - want_t).max() < POSE_TRANS_M
    assert rot_diff_rad(solved.db.rot[:n].numpy(), np.asarray(jsolved.db.rot[:n])).max() < \
        POSE_ROT_RAD
    np.testing.assert_allclose(solved.xyz.numpy(), np.asarray(jsolved.xyz), atol=POSE_TRANS_M)


def test_port_state_continues_in_reference():
    """The state after the port's loop step, carried back into the JAX
    package, solves there as the port's own solve does; the loop factor
    alone moves the drifted return (0.39 m off in y at keyframe 13) toward
    the start (a little: its variance is the ICP fitness, the odometry's
    1e-4)."""
    cfg = _config()
    pts = _ground()
    jstate, _ = _jax_start(cfg, jgr.GroundMap(jnp.asarray(pts), jnp.ones(len(pts), bool)))
    state = bk.backend_state_from_numpy(bk.backend_state_to_numpy(jstate), "cpu")
    state, _ = bk.loop_closure_step(state, port_config(cfg))
    arrays = bk.backend_state_to_numpy(state)
    rebuilt = jax_backend_state(arrays)
    jsolved = jbk.solve_graph_host(rebuilt, cfg)
    solved = bk.solve_graph_host(state, port_config(cfg))
    assert np.abs(solved.db.trans.numpy() - np.asarray(jsolved.db.trans)).max() < POSE_TRANS_M
    before = float(arrays["db.trans"][13, 1])
    assert abs(float(solved.db.trans[13, 1])) < abs(before) - 1e-3


def jax_backend_state(arrays):
    """A JAX BackendState from backend_state_to_numpy's layout."""
    from rolo_tpu.graph.factors import BetweenFactors, PoseGraph
    from rolo_tpu.loop.scancontext import ScanContextDB
    from rolo_tpu.mapping.keyframes import KeyframeDB
    from rolo_tpu.prior.association import PriorQueue

    def build(cls, prefix):
        nested = {"db": KeyframeDB, "graph": PoseGraph, "scdb": ScanContextDB,
                  "prior_queue": PriorQueue, "loops": BetweenFactors, "priors": BetweenFactors}
        return cls(**{name: build(nested[name], f"{prefix}{name}.") if name in nested
                      else jnp.asarray(arrays[f"{prefix}{name}"]) for name in cls._fields})

    return build(jbk.BackendState, "")
