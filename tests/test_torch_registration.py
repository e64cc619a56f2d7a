"""Parity of the port's rot-GICP registration with the JAX reference at
B=2, batched-vs-per-pair equality of the masked LM loops, and the whole
slice: raw simulated scans -> features -> registration, each package on its
own end to end."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import (T, jax_config, jax_features, jax_sim_frames, rot_err_deg,
                          small_config, small_sim_kwargs, torch_features)

from rolo_tpu.registration.rotgicp import register_scan_pair as jregister

from rolo_tpu_torch.bench import gt_relative
from rolo_tpu_torch.registration.rotgicp import register_scan_pair
from rolo_tpu_torch.sim.dataset import SimConfig, generate_sequence

K = 20
STRIDE = 2
# Final-pose agreement of the two packages on the same features. Their
# covariances differ slightly by design (the reference's CPU moment path
# takes the exact k-th distance, the port bisects with kernel K2's
# contract), and an f32 LM exit can differ by one iteration.
POSE_ROT_DEG = 0.05
POSE_TRANS_M = 0.005


@functools.lru_cache(maxsize=None)
def _jax_batched(capacity):
    cfg = jax_config().registration
    return jax.jit(jax.vmap(lambda s, sm, t, tm, g, l, d: jregister(
        s, sm, t, tm, g, l, d, d, cfg, capacity, K)))


def _pairs(xyz, mask, batch):
    return (xyz[:batch], mask[:batch], xyz[STRIDE:STRIDE + batch], mask[STRIDE:STRIDE + batch])


def _run_jax(src, sm, tgt, tm):
    b = src.shape[0]
    cap = jax_config().static.max_voxels
    res = _jax_batched(cap)(src, sm, tgt, tm, jnp.zeros((b, 3)), jnp.zeros((b, 3)),
                            jnp.full((b,), 0.2, jnp.float32))
    return np.asarray(res.rot), np.asarray(res.trans)


def _run_torch(src, sm, tgt, tm):
    cfg = small_config()
    b = src.shape[0]
    z = torch.zeros(b, 3)
    dt = torch.full((b,), 0.2)
    return register_scan_pair(T(src), T(sm), T(tgt), T(tm), z, z, dt, dt, cfg.registration,
                              cfg.static.max_voxels, K)


@pytest.fixture(scope="module")
def noisy_features():
    return jax_features(jax_sim_frames(2 + STRIDE), jax_config())


def test_register_scan_pair_matches_reference(noisy_features):
    src, sm, tgt, tm = _pairs(*noisy_features, 2)
    jrot, jtrans = _run_jax(src, sm, tgt, tm)
    res = _run_torch(src, sm, tgt, tm)
    assert (rot_err_deg(res.rot.numpy(), jrot) < POSE_ROT_DEG).all()
    assert (np.linalg.norm(res.trans.numpy() - jtrans, axis=1) < POSE_TRANS_M).all()


def test_batched_equals_per_pair(noisy_features):
    """Frozen instances keep their state: a batch gives per-pair results."""
    src, sm, tgt, tm = _pairs(*noisy_features, 2)
    both = _run_torch(src, sm, tgt, tm)
    for i in range(2):
        one = _run_torch(src[i:i + 1], sm[i:i + 1], tgt[i:i + 1], tm[i:i + 1])
        torch.testing.assert_close(one.rot[0], both.rot[i], rtol=0, atol=1e-6)
        torch.testing.assert_close(one.trans[0], both.trans[i], rtol=0, atol=1e-6)
        assert int(one.rot_iterations[0]) == int(both.rot_iterations[i])


def test_whole_slice_matches_reference():
    """Noise-free scans (the two packages' noise draws differ by design):
    each package simulates, featurizes and registers on its own."""
    jframes = jax_sim_frames(2 + STRIDE, noise=False)
    jrot, jtrans = _run_jax(*_pairs(*jax_features(jframes, jax_config()), 2))
    frames = list(generate_sequence(SimConfig(**small_sim_kwargs(2 + STRIDE, noise=False)),
                                    "cpu"))
    res = _run_torch(*_pairs(*torch_features(frames, small_config()), 2))
    assert (rot_err_deg(res.rot.numpy(), jrot) < POSE_ROT_DEG).all()
    assert (np.linalg.norm(res.trans.numpy() - jtrans, axis=1) < POSE_TRANS_M).all()
    # and both recover the simulated motion at this reduced sensor size
    gt = [gt_relative(frames[i].gt_rot, frames[i].gt_trans, frames[i + STRIDE].gt_rot,
                      frames[i + STRIDE].gt_trans) for i in range(2)]
    assert (rot_err_deg(res.rot.numpy(), np.stack([g[0].numpy() for g in gt])) < 1.0).all()
    assert (np.linalg.norm(res.trans.numpy() - np.stack([g[1].numpy() for g in gt]), axis=1)
            < 0.1).all()
