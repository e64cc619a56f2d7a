"""The pose ESKF and odometry fusion of the port against the JAX reference:
every public function on the same inputs, one call at a time and over a
sequence of 40 noisy measurements, and FusionState carried between the
packages in both directions.

Tolerances are relative to each field's magnitude (max |reference| in the
state compared, or over the whole reference run for a sequence): 1e-5 for
one call, 1e-4 over a sequence (f32 rounding compounds through the iterated
updates and the 18x18 covariance products)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import T, port_config

from rolo_tpu.config import FilterConfig as JFilterConfig
from rolo_tpu.filter import eskf as jeskf
from rolo_tpu.filter import fusion as jfusion

from rolo_tpu_torch.filter import eskf, fusion

CFG = JFilterConfig()
ONE_CALL, SEQUENCE = 1e-5, 1e-4


@functools.lru_cache(maxsize=None)
def _pcfg():
    return port_config(CFG)


def _close(got, want, rel, err="", scales=None):
    """Every field of two NamedTuples (or two arrays), relative to each
    field's largest reference magnitude (or to `scales[field path]`)."""
    if hasattr(want, "_fields"):
        for name in want._fields:
            _close(getattr(got, name), getattr(want, name), rel, f"{err}.{name}", scales)
        return
    g = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    if w.dtype == bool:
        np.testing.assert_array_equal(g, w, err_msg=err)
        return
    scale = scales[err] if scales else max(float(np.abs(w).max(initial=0.0)), 1e-12)
    np.testing.assert_allclose(g, w, rtol=0, atol=rel * scale, err_msg=err)


def _yaw_rot(yaw):
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def _trajectory(n=40, seed=0):
    """Measurements of a vehicle curving at 2 m/s with a 0.4 rad/s yaw rate
    and 1 cm / 2 mrad of noise, at 10 Hz."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = 0.1 * i
        yaw = 0.4 * t + rng.normal(0, 2e-3)
        pos = np.array([2.0 * np.sin(0.4 * t) / 0.4, 2.0 * (1 - np.cos(0.4 * t)) / 0.4, 0.05 * t])
        out.append((np.float32(t), (pos + rng.normal(0, 0.01, 3)).astype(np.float32),
                    _yaw_rot(yaw)))
    return out


def _to_port(state):
    """A JAX ESKFState as the port's, through numpy."""
    return eskf.ESKFState(*(T(np.asarray(f)) for f in state))


@functools.lru_cache(maxsize=None)
def _jax_run(n=40):
    """The reference filter over the trajectory: the state after each call."""
    st = jeskf.init_filter(CFG)
    states = []
    for t, pos, rot in _trajectory(n):
        st, ok = jeskf.process_measurement(st, t, jnp.asarray(pos), jnp.asarray(rot), CFG)
        states.append((jax.tree_util.tree_map(np.asarray, st), bool(ok)))
    return states


def test_init_filter_matches_reference():
    _close(eskf.init_filter(_pcfg(), "cpu"), jeskf.init_filter(CFG), 0.0)


@pytest.mark.parametrize("dt", [0.1, 0.37, 1e-4])
def test_predict_matches_reference(dt):
    base = _jax_run()[10][0]
    _close(eskf.predict(_to_port(base), dt, _pcfg()), jeskf.predict(base, dt, CFG), ONE_CALL)


def test_update_iterated_matches_reference():
    base = jeskf.predict(_jax_run()[10][0], 0.1, CFG)
    t, pos, rot = _trajectory()[11]
    want = jeskf.update_iterated(base, jnp.asarray(pos), jnp.asarray(rot), CFG)
    got = eskf.update_iterated(_to_port(base), T(pos), T(rot), _pcfg())
    _close(got, want, ONE_CALL)
    r_diag = np.array([0.1, 0.2, 0.3, 0.01, 0.02, 0.03], np.float32)
    _close(eskf.update_iterated(_to_port(base), T(pos), T(rot), _pcfg(), T(r_diag)),
           jeskf.update_iterated(base, jnp.asarray(pos), jnp.asarray(rot), CFG,
                                 jnp.asarray(r_diag)), ONE_CALL)


@pytest.mark.parametrize("case", ["first", "update", "stale", "same_time", "gap"])
def test_process_measurement_matches_reference(case):
    """One call from the states of the reference run: initialize, update,
    reject a stamp in the past or equal, re-initialize after a gap."""
    runs = _jax_run()
    base = jeskf.init_filter(CFG) if case == "first" else runs[12][0]
    t, pos, rot = _trajectory()[13]
    t = {"first": t, "update": t, "stale": 0.5, "same_time": float(base.last_time),
         "gap": t + 3.0}[case]
    want, wok = jeskf.process_measurement(base, t, jnp.asarray(pos), jnp.asarray(rot), CFG)
    got, ok = eskf.process_measurement(_to_port(base), t, T(pos), T(rot), _pcfg())
    assert bool(ok) == bool(wok) == (case not in ("stale", "same_time"))
    _close(got, want, ONE_CALL)


def _run_scales(states, prefix=""):
    """Each field's largest magnitude over a reference run."""
    first = states[0]
    if hasattr(first, "_fields"):
        out = {}
        for name in first._fields:
            out.update(_run_scales([getattr(s, name) for s in states], f"{prefix}.{name}"))
        return out
    return {prefix: max(float(np.abs(np.asarray(s, np.float64)).max()) for s in states)}


def test_filter_sequence_matches_reference():
    """40 measurements through both filters, compared after every call."""
    scales = _run_scales([s for s, _ in _jax_run()])
    st = eskf.init_filter(_pcfg(), "cpu")
    for (t, pos, rot), (want, wok) in zip(_trajectory(), _jax_run()):
        st, ok = eskf.process_measurement(st, t, T(pos), T(rot), _pcfg())
        assert bool(ok) == wok
        _close(st, want, SEQUENCE, scales=scales)
    assert abs(float(st.omega[2]) - 0.4) < 0.15  # the filter tracks the yaw rate


@pytest.mark.parametrize("ahead", [0.05, 0.0, -0.1, 2.0])
def test_state_predict_matches_reference(ahead):
    base = _jax_run()[30][0]
    t = float(base.last_time) + ahead
    want, wok = jeskf.state_predict(base, t, CFG)
    got, ok = eskf.state_predict(_to_port(base), t, _pcfg())
    assert bool(ok) == bool(wok) == (0.0 < ahead <= CFG.max_dt)
    _close(got, want, ONE_CALL)


@pytest.mark.parametrize("index", [0, 5, 39])
def test_state_propagate_matches_reference(index):
    """The rollout over up to 64 masked steps; the first state is fresh (no
    velocity, so the rollout is empty)."""
    base = _jax_run()[index][0]
    want = jeskf.state_propagate(base, CFG)
    got = eskf.state_propagate(_to_port(base), _pcfg())
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert int(got.final_index) == int(want.final_index)
    assert bool(got.mask.any()) == (index > 0)
    _close(got.pos, want.pos, ONE_CALL)
    _close(got.quat, want.quat, ONE_CALL)


@functools.lru_cache(maxsize=None)
def _jax_fusion_run():
    """The reference fusion: the front-end feeds every scan, the mapping
    pose (offset by a fixed correction) every second scan; the state after
    each scan."""
    fs = jfusion.init_fusion(CFG)
    corr_rot = _yaw_rot(0.05)
    states = []
    for i, (t, pos, rot) in enumerate(_trajectory(24)):
        fs, _ = jfusion.on_front_odometry(fs, t, jnp.asarray(rot), jnp.asarray(pos), CFG)
        if i % 2 == 0:
            fs = jfusion.on_mapping_odometry(fs, jnp.asarray(corr_rot @ rot),
                                             jnp.asarray(corr_rot @ pos + 0.3),
                                             jnp.asarray(rot), jnp.asarray(pos))
        states.append(jax.tree_util.tree_map(np.asarray, fs))
    return states


def test_fusion_sequence_matches_reference():
    fs = fusion.init_fusion(_pcfg(), "cpu")
    _close(fs, jfusion.init_fusion(CFG), 0.0)
    corr_rot = _yaw_rot(0.05)
    scales = _run_scales(_jax_fusion_run())
    for i, ((t, pos, rot), want) in enumerate(zip(_trajectory(24), _jax_fusion_run())):
        fs, ok = fusion.on_front_odometry(fs, t, T(rot), T(pos), _pcfg())
        assert bool(ok)
        if i % 2 == 0:
            fs = fusion.on_mapping_odometry(fs, T(corr_rot @ rot), T(corr_rot @ pos + 0.3),
                                            T(rot), T(pos))
        _close(fs, want, SEQUENCE, scales=scales)


@pytest.mark.parametrize("index,ahead", [(0, 0.05), (7, 0.03), (23, 0.1), (23, 5.0)])
def test_fused_pose_and_future_match_reference(index, ahead):
    """fused_pose (valid only once a mapping pose exists and never advancing
    the filter) and predict_future from the reference's states."""
    want_state = _jax_fusion_run()[index]
    state = fusion.fusion_state_from_numpy(fusion.fusion_state_to_numpy(want_state), "cpu")
    t = float(want_state.filter.last_time) + ahead
    want = jfusion.fused_pose(want_state, t, CFG)
    got = fusion.fused_pose(state, t, _pcfg())
    _close(got, want, ONE_CALL)
    assert bool(got.valid)
    wfut = jfusion.predict_future(want_state, CFG)
    fut = fusion.predict_future(state, _pcfg())
    _close(fut, wfut, ONE_CALL)
    assert bool(fut.valid) == (index > 0) and float(fut.local_pos[:, 2].abs().max()) == 0.0


def test_fused_pose_invalid_before_mapping():
    fs = fusion.init_fusion(_pcfg(), "cpu")
    fs, _ = fusion.on_front_odometry(fs, 0.0, torch.eye(3), torch.zeros(3), _pcfg())
    assert not bool(fusion.fused_pose(fs, 0.1, _pcfg()).valid)


def test_fusion_state_crosses_packages_both_ways():
    """A JAX FusionState continues in the port and a port state continues
    in the JAX package, with the same shapes, dtypes and results."""
    jstate = _jax_fusion_run()[15]
    arrays = fusion.fusion_state_to_numpy(jstate)
    assert "filter.cov" in arrays and arrays["filter.cov"].shape == (18, 18)
    state = fusion.fusion_state_from_numpy(arrays, "cpu")
    back = fusion.fusion_state_to_numpy(state)
    assert set(back) == set(arrays)
    for key, value in arrays.items():
        assert back[key].dtype == value.dtype, key
        np.testing.assert_array_equal(back[key], value, err_msg=key)
    t, pos, rot = _trajectory(24)[16]
    state, _ = fusion.on_front_odometry(state, t, T(rot), T(pos), _pcfg())
    want, _ = jfusion.on_front_odometry(jstate, t, jnp.asarray(rot), jnp.asarray(pos), CFG)
    _close(state, want, ONE_CALL)
    # and back: the port's state rebuilt as the reference's
    ported = fusion.fusion_state_to_numpy(state)
    jback = jfusion.FusionState(
        filter=jeskf.ESKFState(*(jnp.asarray(ported[f"filter.{f}"])
                                 for f in jeskf.ESKFState._fields)),
        **{f: jnp.asarray(ported[f]) for f in jfusion.FusionState._fields if f != "filter"})
    t, pos, rot = _trajectory(24)[17]
    jnext, _ = jfusion.on_front_odometry(jback, t, jnp.asarray(rot), jnp.asarray(pos), CFG)
    nxt, _ = fusion.on_front_odometry(state, t, T(rot), T(pos), _pcfg())
    _close(nxt, jnext, ONE_CALL)
