"""Batched multi-sequence mapping against the JAX reference: the port's
backend_step over a leading [B] against `jax.vmap(backend_step)` at
__graft_entry__.py's small mapping config (3 sequences x 3 steps through
tools/bench_batch_mapping.py's synthetic worlds), every
instance of a batch bit-equal to its unbatched run (also while one instance
has no keyframe and the others have), batched solve_pose_graph against
single solves and the reference's vmapped dense solve, batched "pcg"
(chain and jacobi) against the reference's vmapped pcg, each graph with its
own CG stop, and the batched host solve's bucket and its keyframe-less
instance."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import pytest
import torch

from torch_parity import T, port_config, rot_err_deg

from rolo_tpu.config import LoopConfig as JLoopConfig
from rolo_tpu.config import MappingConfig as JMappingConfig
from rolo_tpu.config import RoloConfig as JRoloConfig
from rolo_tpu.config import StaticConfig as JStaticConfig
from rolo_tpu.graph.solver import solve_pose_graph as jsolve_pose_graph
from rolo_tpu.mapping import backend as jbk
from rolo_tpu.pointcloud.cloud import PaddedCloud as JCloud

from rolo_tpu_torch.graph import solver
from rolo_tpu_torch.graph.factors import BetweenFactors, PoseGraph
from rolo_tpu_torch.graph.solver import solve_pose_graph
from rolo_tpu_torch.mapping import backend as bk
from rolo_tpu_torch.ops.pytree import tree_index, tree_leaves, tree_stack
from rolo_tpu_torch.pointcloud.cloud import PaddedCloud

B, STEPS = 3, 3
# tests/test_torch_backend.py:34: one mapping step from the same state and
# inputs differs between the packages by up to 0.08 deg / 6 mm
STEP_ROT_DEG, STEP_TRANS_M = 0.15, 0.01
DESC_TOL = 1e-5
SOLVE_TRANS_M = 1e-4  # __graft_entry__.py:249-250's dense / bcr agreement


@functools.lru_cache(maxsize=None)
def _configs():
    """__graft_entry__.py:162-173's batched-mapping config in both packages."""
    jcfg = JRoloConfig(
        mapping=JMappingConfig(scan2map_max_iterations=4), loop=JLoopConfig(enable=False),
        static=JStaticConfig(max_raw_points=2048, max_corner_points=128, max_surf_points=256,
                             max_feature_points=384, max_voxels=512, max_keyframes=8,
                             max_submap_points=1024, max_loop_factors=4, max_prior_factors=4,
                             knn_query_chunk=128))
    return jcfg, port_config(jcfg)


def _world(seed, n_surf, n_corner):
    """tools/bench_batch_mapping.py:30-56: four walls (one diagonal, one the
    floor) and six vertical pillars, with 5 mm noise."""
    rng = np.random.default_rng(seed)
    walls = []
    for nv, d in [((1, 0, 0), 8.0), ((0, 1, 0), 10.0), ((0, 0, 1), -1.5), ((0.7, 0.7, 0), 12.0)]:
        m = n_surf // 4
        nv = np.array(nv, np.float64)
        nv /= np.linalg.norm(nv)
        t1 = np.cross(nv, [0, 0, 1.0] if abs(nv[2]) < 0.9 else [1.0, 0, 0])
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(nv, t1)
        u = rng.uniform(-2.0, 2.0, (m, 2))
        walls.append(d * nv + u[:, :1] * t1 + u[:, 1:] * t2)
    surf = np.concatenate(walls)[:n_surf].astype(np.float32)
    surf += rng.normal(0, 0.005, surf.shape).astype(np.float32)
    pts = []
    for px, py in [(4.0, 2.0), (6.0, -3.0), (9.0, 1.0), (3.0, -1.5), (7.5, 3.5), (2.0, 0.5)]:
        m = n_corner // 6
        z = rng.uniform(-1.0, 2.0, (m, 1))
        pts.append(np.concatenate([np.full((m, 1), px), np.full((m, 1), py), z], axis=1))
    corner = np.concatenate(pts)[:n_corner].astype(np.float32)
    corner += rng.normal(0, 0.005, corner.shape).astype(np.float32)
    return corner, surf


@functools.lru_cache(maxsize=None)
def _inputs():
    """Per step: corners, corner masks, surfaces, surface masks [B, ...] and
    the guesses [B, 3] (tools/bench_batch_mapping.py:98-116): sequence b
    advances 0.8 + 0.03 b m a step along x through its own world, from a
    guess 2 cm off after the first step."""
    st = _configs()[0].static
    gt = np.zeros((B, STEPS, 3), np.float32)
    for b in range(B):
        gt[b, :, 0] = (0.8 + 0.03 * b) * np.arange(STEPS)
    worlds = [_world(100 + b, st.max_surf_points, st.max_corner_points) for b in range(B)]
    noise = np.random.default_rng(0).normal(0, 0.02, (STEPS, B, 3)).astype(np.float32)
    noise[0] = 0.0
    steps = []
    for s in range(STEPS):
        corners = np.stack([c - gt[b, s] for b, (c, _) in enumerate(worlds)])
        surfs = np.stack([w - gt[b, s] for b, (_, w) in enumerate(worlds)])
        steps.append((corners, np.ones(corners.shape[:2], bool), surfs,
                      np.ones(surfs.shape[:2], bool), gt[:, s] + noise[s]))
    return gt, steps


def _port_args(step, idx=slice(None)):
    corners, cmask, surfs, smask, guess = (T(x[idx]) for x in step)
    surf = PaddedCloud(surfs, smask)
    eye = torch.eye(3).expand(*guess.shape[:-1], 3, 3)
    return PaddedCloud(corners, cmask), surf, surf, eye, guess


@functools.lru_cache(maxsize=None)
def _jax_run():
    """The reference's vmapped run: per step the states it started from (as
    numpy) and its outputs, and the final states."""
    jcfg = _configs()[0]
    states = jtu.tree_map(lambda *xs: jnp.stack(xs), *[jbk.init_backend(jcfg) for _ in range(B)])
    step = jax.jit(jax.vmap(lambda s, c, cm, f, fm, tr, t: jbk.backend_step(
        s, JCloud(c, cm), JCloud(f, fm), JCloud(f, fm), jnp.eye(3), tr, jnp.asarray(True), t,
        jcfg)))
    befores, outs = [], []
    for s, (corners, cmask, surfs, smask, guess) in enumerate(_inputs()[1]):
        befores.append(bk.backend_state_to_numpy(states))
        states, out = step(states, corners, cmask, surfs, smask, guess,
                           jnp.full((B,), 0.5 * s, jnp.float32))
        outs.append(out)
    return befores, outs, states


@functools.lru_cache(maxsize=None)
def _port_batched():
    cfg = _configs()[1]
    states = bk.init_backend(cfg, "cpu", batch=B)
    outs = []
    for s, step in enumerate(_inputs()[1]):
        states, out = bk.backend_step(states, *_port_args(step), True, 0.5 * s, cfg)
        outs.append(out)
    return outs, states


def _same_bits(got, want):
    got, want = tree_leaves(got), tree_leaves(want)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def test_batched_backend_step_matches_vmapped_reference():
    """Each batched step from the reference's own states before it, as
    tests/test_torch_backend.py carries a JAX state into the port: every
    step is degenerate at these capacities, so a few flipped plane gates
    compound over steps."""
    cfg = _configs()[1]
    befores, want_outs, _ = _jax_run()
    for s, (before, want, step) in enumerate(zip(befores, want_outs, _inputs()[1])):
        state = bk.backend_state_from_numpy(before, "cpu")
        state, got = bk.backend_step(state, *_port_args(step), True, 0.5 * s, cfg)
        assert np.array_equal(got.keyframe_added.numpy(), np.asarray(want.keyframe_added))
        assert rot_err_deg(got.rot.numpy(), np.asarray(want.rot)).max() < STEP_ROT_DEG
        assert np.abs(got.trans.numpy() - np.asarray(want.trans)).max() < STEP_TRANS_M
        after = befores[s + 1] if s + 1 < STEPS else bk.backend_state_to_numpy(_jax_run()[2])
        assert np.array_equal(state.db.count.numpy(), after["db.count"])
        np.testing.assert_allclose(state.scdb.desc.numpy(), after["scdb.desc"], atol=DESC_TOL)
    _, got_states = _port_batched()
    assert (got_states.db.count.numpy() == STEPS).all()
    gt = _inputs()[0]
    assert np.linalg.norm(got_states.db.trans[:, :STEPS].numpy() - gt, axis=-1).max() < 0.25


def test_batch_gives_each_sequence_its_unbatched_bits():
    cfg = _configs()[1]
    got_outs, got_states = _port_batched()
    for b in range(B):
        state = bk.init_backend(cfg, "cpu")
        for s, step in enumerate(_inputs()[1]):
            state, out = bk.backend_step(state, *_port_args(step, b), True, 0.5 * s, cfg)
            _same_bits(tree_index(got_outs[s], b), out)
        _same_bits(tree_index(got_states, b), state)


def test_batch_with_a_keyframe_less_instance_gives_each_its_bits():
    """Two sequences one step in and one not started, stepped as one batch:
    scan-to-map runs for the batch and the fresh instance takes none of it."""
    cfg = _configs()[1]
    steps = _inputs()[1]
    singles = []
    for b in range(B):
        state = bk.init_backend(cfg, "cpu")
        if b < B - 1:
            state, _ = bk.backend_step(state, *_port_args(steps[0], b), True, 0.0, cfg)
        singles.append(state)
    batch = tree_stack(singles)  # copies: the singles go on alone
    assert batch.db.count.tolist() == [1, 1, 0]
    for rnd in range(2):
        idx = [rnd + 1, rnd + 1, rnd]
        inputs = [_port_args(steps[i], b) for b, i in enumerate(idx)]
        stacked = [torch.stack([x[k] for x in inputs]) for k in (3, 4)]
        clouds = [PaddedCloud(torch.stack([x[k].xyz for x in inputs]),
                              torch.stack([x[k].mask for x in inputs])) for k in range(3)]
        times = torch.tensor([0.5 * i for i in idx])
        batch, out = bk.backend_step(batch, *clouds, *stacked, True, times, cfg)
        for b in range(B):
            singles[b], one = bk.backend_step(singles[b], *inputs[b], True, times[b], cfg)
            _same_bits(tree_index(out, b), one)
            _same_bits(tree_index(batch, b), singles[b])
        if rnd == 0:
            assert out.s2m_iterations.tolist()[2] == 0 and min(out.s2m_iterations[:2]) > 0


@pytest.mark.parametrize("method", ["dense", "bcr"])
def test_batched_solve_pose_graph_matches_single_solves(method):
    """The batched solve of the reference's three graphs (carried into the
    port): each instance bit-equal to its single solve, and within 1e-4 m of
    the reference's vmapped dense solve."""
    jstates = _jax_run()[2]
    states = bk.backend_state_from_numpy(bk.backend_state_to_numpy(jstates), "cpu")
    db = states.db
    sol = solve_pose_graph(states.graph, db.rot, db.trans, db.count, method=method)
    for b in range(B):
        one = tree_index(states, b)
        single = solve_pose_graph(one.graph, one.db.rot, one.db.trans, one.db.count,
                                  method=method)
        _same_bits(tree_index(sol, b), single)
    want = _jax_dense_solve()
    assert np.abs(sol.trans[:, :STEPS].numpy() - want[:, :STEPS]).max() < SOLVE_TRANS_M
    drift = np.linalg.norm(sol.trans[:, :STEPS].numpy() - db.trans[:, :STEPS].numpy(), axis=-1)
    assert drift.max() < 0.05


@functools.lru_cache(maxsize=None)
def _jax_dense_solve():
    """__graft_entry__.py:239-241: the reference's vmapped dense solve."""
    js = _jax_run()[2]
    solve = jax.jit(jax.vmap(lambda g, r, t, c: jsolve_pose_graph(g, r, t, c, method="dense")))
    return np.asarray(solve(js.graph, js.db.rot, js.db.trans, js.db.count).trans)


PCG_K, PCG_CAP = 64, 16  # the bag fixture's keyframe and factor capacities
PCG_COUNTS = (40, 25, 1)
POSE_TOL = 2e-4  # tests/test_torch_graph.py's pcg parity tolerance


def _rodrigues(w):
    w = np.asarray(w, np.float64)
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / max(th, 1e-12)
    return np.eye(3) + np.sin(th) * k + (1 - np.cos(th)) * k @ k


@functools.lru_cache(maxsize=None)
def _pcg_graphs():
    """Three graphs at the bag fixture's capacities, as numpy: 40 poses
    round a circle with a robust loop factor and a prior factor, an
    odometry-only chain of 25, and a graph of one pose. Noisy odometry and
    a drifted estimate; unused slots hold the identity."""
    rng = np.random.default_rng(8)
    odom_rot = np.tile(np.eye(3), (B, PCG_K, 1, 1))
    odom_trans = np.zeros((B, PCG_K, 3))
    est_rot = np.tile(np.eye(3), (B, PCG_K, 1, 1))
    est_trans = np.zeros((B, PCG_K, 3))
    factors = []
    for b, n in enumerate(PCG_COUNTS):
        step = _rodrigues([0.0, 0.0, 2 * np.pi / max(n, 2)]), np.array([2.0, 0.0, 0.0])
        true = [(np.eye(3), np.zeros(3))]
        for i in range(1, n):
            r, t = true[-1]
            true.append((r @ step[0], r @ step[1] + t))
            odom_rot[b, i] = step[0]
            odom_trans[b, i] = step[1] + rng.normal(0, 0.03, 3)
            pr, pt = _rodrigues(rng.normal(0, 0.01, 3)), rng.normal(0, 0.05, 3)
            r0, t0 = est_rot[b, i - 1], est_trans[b, i - 1]
            r1, t1 = r0 @ odom_rot[b, i], r0 @ odom_trans[b, i] + t0
            est_rot[b, i], est_trans[b, i] = r1 @ pr, r1 @ pt + t1

        def rel(i, j):
            (ri, ti), (rj, tj) = true[i], true[j]
            return ri.T @ rj, ri.T @ (tj - ti)

        factors.append({"loop": [(n - 1, 0, *rel(n - 1, 0), 1e-4, 0.5)],
                        "prior": [(2, 5, *rel(2, 5), 1e-3, None)]} if b == 0 else {})
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    return f32(odom_rot), f32(odom_trans), f32(est_rot), f32(est_trans), factors


@functools.lru_cache(maxsize=None)
def _pcg_jax_inputs():
    from rolo_tpu.graph import add_between as jadd_between, empty_graph as jempty_graph

    odom_rot, odom_trans, est_rot, est_trans, factors = _pcg_graphs()
    graphs = []
    for b in range(B):
        g = jempty_graph(PCG_K, PCG_CAP, PCG_CAP)
        g = g._replace(odom_rel_rot=jnp.asarray(odom_rot[b]),
                       odom_rel_trans=jnp.asarray(odom_trans[b]))
        for kind, field in (("loop", "loops"), ("prior", "priors")):
            store = getattr(g, field)
            for i, j, r, t, var, c in factors[b].get(kind, ()):
                store = jadd_between(store, i, j, jnp.asarray(r, jnp.float32),
                                     jnp.asarray(t, jnp.float32), jnp.full(6, var, jnp.float32),
                                     robust_c=None if c is None else jnp.float32(c))
            g = g._replace(**{field: store})
        graphs.append(g)
    return (jtu.tree_map(lambda *xs: jnp.stack(xs), *graphs), jnp.asarray(est_rot),
            jnp.asarray(est_trans), jnp.asarray(PCG_COUNTS, jnp.int32))


def _pcg_port_inputs():
    """The reference's graphs carried into the port, as [B] tensors."""
    graph, rot, trans, count = _pcg_jax_inputs()
    between = [BetweenFactors(*(T(np.asarray(x)) for x in f)) for f in graph[4:]]
    return (PoseGraph(*(T(np.asarray(x)) for x in graph[:4]), *between), T(np.asarray(rot)),
            T(np.asarray(trans)), T(np.asarray(count)))


@functools.lru_cache(maxsize=None)
def _jax_pcg_solve(preconditioner):
    solve = jax.jit(jax.vmap(lambda g, r, t, c: jsolve_pose_graph(
        g, r, t, c, method="pcg", preconditioner=preconditioner)))
    sol = solve(*_pcg_jax_inputs())
    return np.asarray(sol.rot), np.asarray(sol.trans)


@pytest.mark.parametrize("preconditioner", ["chain", "jacobi"])
def test_batched_pcg_solve_matches_vmapped_reference(preconditioner):
    """Batched "pcg" on three graphs (loops and priors, odometry only, one
    pose) against `jax.vmap` of the reference's pcg solve, each instance
    bit-equal to its solve alone."""
    graph, rot, trans, count = _pcg_port_inputs()
    sol = solve_pose_graph(graph, rot, trans, count, method="pcg",
                           preconditioner=preconditioner)
    want_rot, want_trans = _jax_pcg_solve(preconditioner)
    np.testing.assert_allclose(sol.trans.numpy(), want_trans, atol=POSE_TOL)
    np.testing.assert_allclose(sol.rot.numpy(), want_rot, atol=POSE_TOL)
    for b in range(B):
        one = tree_index((graph, rot, trans, count), b)
        _same_bits(tree_index(sol, b), solve_pose_graph(*one, method="pcg",
                                                        preconditioner=preconditioner))
    # the loop factor pulls graph 0's last pose back to one 2 m step from
    # its first (the drifted estimate: 2.5 m); the odometry-only graph's
    # inactive slots and the one-pose graph stay where they were
    gap = np.linalg.norm(sol.trans[0, PCG_COUNTS[0] - 1].numpy() - sol.trans[0, 0].numpy())
    assert abs(gap - 2.0) < 0.1
    assert torch.equal(sol.trans[1, PCG_COUNTS[1]:], trans[1, PCG_COUNTS[1]:])
    assert torch.equal(sol.trans[2], trans[2])


@pytest.mark.parametrize("preconditioner", ["chain", "jacobi"])
def test_batched_cg_stops_each_graph_on_its_own_test(preconditioner):
    """One CG solve over the three graphs' first linearization: each takes
    its own number of iterations (the one-pose graph none), and each
    instance's step has the bits of its CG run alone, the stopped ones
    frozen while the loop runs on."""
    graph, rot, trans, count = _pcg_port_inputs()
    k = PCG_K

    def cg(g, r, t, c):
        blocks = solver._linearize(g, r, t, c)
        active = (torch.arange(k) < torch.as_tensor(c)[..., None])[..., None]
        return solver._pcg(blocks, k, 1e-6, active, solver._gradient(blocks, k), 1000, 1e-8,
                           preconditioner)

    x, steps = cg(graph, rot, trans, count)
    assert len(set(steps.tolist())) == B and steps[2] == 0, steps
    for b in range(B):
        x1, steps1 = cg(*tree_index((graph, rot, trans, count), b))
        assert torch.equal(x[b], x1) and torch.equal(steps[b], steps1)
    assert torch.isfinite(x).all()


def test_batched_host_solve_takes_the_largest_count_and_spares_an_empty_instance(monkeypatch):
    """Counts 0, 1 and 100 in a 128-keyframe store: one solve at bucket 128
    (the count of 1 alone would take 64); the instance without keyframes
    keeps every bit; the others equal single solves at the same bucket."""
    cfg = _configs()[1]
    cfg = cfg.replace(static=dataclasses.replace(cfg.static, max_keyframes=128))
    rng = np.random.default_rng(3)
    states = bk.init_backend(cfg, "cpu", batch=3)
    counts = [0, 1, 100]
    for b, n in enumerate(counts):
        steps = np.zeros((128, 3), np.float32)
        steps[:, 0] = 0.5
        trans = np.cumsum(steps, 0) - steps + rng.normal(0, 0.01, (128, 3)).astype(np.float32)
        states.db.trans[b] = T(trans)
        states.graph.odom_rel_trans[b] = T(steps)
        states.db.count[b] = n
        states.xyz[b] = T(trans[max(n - 1, 0)] + 0.1)
    states = states._replace(pending_solve=torch.ones(3, dtype=torch.bool))
    before = bk.backend_state_to_numpy(states)
    singles = [bk.backend_state_from_numpy(
        {k: v[b] for k, v in before.items()}, "cpu") for b in range(3)]
    buckets = []
    real = bk.solve_pose_graph

    def spy(graph, rot, *args, **kwargs):
        buckets.append(rot.shape[-3])
        return real(graph, rot, *args, **kwargs)

    monkeypatch.setattr(bk, "solve_pose_graph", spy)
    solved = bk.solve_graph_host(states, cfg)
    assert buckets == [128]
    after = bk.backend_state_to_numpy(solved)
    for key in before:
        if key != "pending_solve":
            assert np.array_equal(after[key][0], before[key][0]), key
    assert not solved.pending_solve.any()
    for b in (1, 2):
        _same_bits(tree_index(solved, b), bk.solve_graph_host(singles[b], cfg, count_hint=100))
    assert float(np.abs(after["db.trans"][2] - before["db.trans"][2]).max()) > 0
