"""Loop closure of the port against the JAX reference on the same inputs:
scan-context detection, radius-search detection, loop submaps, the Kabsch
step, point-to-point ICP, loop
verification, and the back-end's loop_closure_step / external_loop_step on
the unit-scale out-and-back world of tests/test_backend.py."""

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import T, out_and_back, port_config, rot_diff_rad
from test_backend import SMALL
from test_loop import _scene, _structured_cloud

from rolo_tpu.config import LoopConfig as JLoopConfig
from rolo_tpu.geometry.se3 import SE3 as JSE3
from rolo_tpu.loop import closure as jcl
from rolo_tpu.loop import scancontext as jsc
from rolo_tpu.mapping import backend as jbk
from rolo_tpu.mapping import keyframes as jkf
from rolo_tpu.pointcloud.cloud import PaddedCloud as JCloud

from rolo_tpu_torch.geometry import so3
from rolo_tpu_torch.loop import closure as cl
from rolo_tpu_torch.loop import scancontext as sc
from rolo_tpu_torch.mapping import backend as bk
from rolo_tpu_torch.mapping.keyframes import KeyframeDB
from rolo_tpu_torch.ops.pytree import tree_from_numpy, tree_to_numpy
from rolo_tpu_torch.pointcloud.cloud import PaddedCloud

# ICP between the packages (acceptance tolerances): the 1-NN distances are
# f32 matmuls summed in different orders, so near-tied neighbours may differ.
ICP_ROT_RAD, ICP_TRANS_M, FITNESS_REL = 1e-3, 1e-3, 1e-3


def _cloud(c):
    return PaddedCloud(T(c.xyz), T(c.mask))


def _jcloud(xyz, mask):
    return JCloud(jnp.asarray(xyz), jnp.asarray(mask))


def test_sc_distance_matches_reference():
    rng = np.random.default_rng(0)
    query = rng.uniform(0, 3, (20, 60)).astype(np.float32)
    query[:, ::7] = 0.0  # empty columns leave the mean
    cand = rng.uniform(0, 3, (4, 7, 20, 60)).astype(np.float32)
    cand[..., ::5] = 0.0
    want = np.asarray(jsc._sc_distance(jnp.asarray(query), jnp.asarray(cand)))
    np.testing.assert_allclose(sc._sc_distance(T(query), T(cand)).numpy(), want, atol=1e-6)


@functools.lru_cache(maxsize=None)
def _descriptors(seeds):
    return np.stack([np.asarray(jsc.make_descriptor(jnp.asarray(_scene(s)), jnp.ones(2048, bool)))
                     for s in seeds])


def _sc_dbs(descs, capacity=64):
    jdb = jsc.init_db(capacity)
    db = sc.init_db(capacity, device="cpu")
    for d in descs:
        jdb = jsc.add_descriptor(jdb, jnp.asarray(d))
        db = sc.add_descriptor(db, T(d))
    return jdb, db


def _rotated(desc, sectors):
    return np.roll(desc, sectors, axis=1)


@pytest.mark.parametrize("case", ["revisit", "rotated_revisit", "all_recent", "novel"])
def test_detect_loop_matches_reference(case):
    """Same winner (index, yaw) and distance to 1e-5. torch.topk and
    lax.top_k may order tied candidates differently; the winner is compared,
    and its index only where a loop is found (with nothing eligible the
    index is an arbitrary masked slot in both)."""
    cfg = dict(sc_num_exclude_recent=10, sc_dist_threshold=0.4)
    if case in ("revisit", "rotated_revisit"):
        descs = list(_descriptors(tuple(range(39))))
        descs.append(_rotated(descs[2], 5 if case == "rotated_revisit" else 0))
    elif case == "all_recent":
        descs = list(_descriptors(tuple(range(5))))
        cfg["sc_num_exclude_recent"] = 30
    else:
        descs = list(_descriptors(tuple(range(100, 140))))
        cfg["sc_dist_threshold"] = 0.1
    jdb, db = _sc_dbs(descs)
    want = jsc.detect_loop(jdb, JLoopConfig(**cfg))
    got = sc.detect_loop(db, port_config(JLoopConfig(**cfg)))
    assert bool(got.found) == bool(want.found)
    assert bool(got.found) == (case in ("revisit", "rotated_revisit"))
    np.testing.assert_allclose(float(got.distance), float(want.distance), atol=1e-5)
    if bool(want.found):
        assert int(got.index) == int(want.index) == 2
        np.testing.assert_allclose(float(got.yaw_rad), float(want.yaw_rad), atol=1e-6)


def _jax_db(n_kf=8, cloud_n=512):
    """tests/test_loop.py's keyframe DB: one structured cloud at x = 2 i."""
    db = jkf.init_db(16, cloud_n, cloud_n)
    pts = jnp.asarray(_structured_cloud(cloud_n))
    for i in range(n_kf):
        pose = JSE3(jnp.eye(3), jnp.asarray([2.0 * i, 0.0, 0.0], jnp.float32))
        db = jkf.add_keyframe(db, pose, jnp.asarray(float(i)), JCloud(pts, jnp.ones(cloud_n, bool)),
                              JCloud(pts, jnp.ones(cloud_n, bool)))
    return db


def _port_db(jdb):
    return tree_from_numpy(KeyframeDB, tree_to_numpy(jdb), "cpu")


@pytest.mark.parametrize("case", ["found", "too_recent", "matched"])
def test_detect_loop_distance_matches_reference(case):
    jdb = _jax_db()
    jdb = jdb._replace(trans=jdb.trans.at[7].set(jnp.asarray([0.3, 0.0, 0.0])))
    if case != "too_recent":
        jdb = jdb._replace(time=jdb.time.at[7].set(100.0))
    matched = np.zeros(16, bool)
    matched[7] = case == "matched"
    want = jcl.detect_loop_distance(jdb, jnp.asarray(matched), 5.0, 30.0)
    got = cl.detect_loop_distance(_port_db(jdb), T(matched), 5.0, 30.0)
    assert bool(got[1]) == bool(want[1]) == (case == "found")
    assert int(got[0]) == int(want[0])


@pytest.mark.parametrize("key,search_num,cap", [(3, 1, 4096), (0, 2, 8192), (7, 0, 512)])
def test_assemble_loop_submap_matches_reference(key, search_num, cap):
    """Slot for slot: both downsample by the same hash sort (1e-5 m)."""
    jdb = _jax_db()
    want = jcl.assemble_loop_submap(jdb, jnp.asarray(key), search_num, cap, 0.4)
    got = cl.assemble_loop_submap(_port_db(jdb), torch.tensor(key), search_num, cap, 0.4)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    m = np.asarray(want.mask)
    assert m.sum() > 100
    np.testing.assert_allclose(got.xyz.numpy()[m], np.asarray(want.xyz)[m], atol=1e-5)


def _jax_kabsch(h):
    """The reference's Kabsch step (closure.py:152-155) on one h."""
    u, _, vt = jnp.linalg.svd(jnp.asarray(h))
    d = jnp.linalg.det(vt.T @ u.T)
    return np.asarray(vt.T @ jnp.diag(jnp.array([1.0, 1.0, 1.0])).at[2, 2].set(d) @ u.T)


def _cross_cov(a, b):
    ca, cb = a.mean(0), b.mean(0)
    return torch.einsum("ni,nj->ij", a - ca, b - cb)


@pytest.mark.parametrize("case", ["general", "plane", "noisy_plane", "square_patch",
                                  "reflection", "large_angle", "zero"])
def test_kabsch_rotation_matches_reference(case):
    """The Kabsch step equals the reference's to 1e-5 (max abs entry) on
    full-rank clouds, planar ones (rank 2, the ground-patch ICP), a
    near-isotropic patch (two equal singular values), a cross covariance
    whose SVD needs the reflection fix, and no correspondences (h = 0)."""
    rng = np.random.default_rng({"general": 0, "plane": 1, "noisy_plane": 2, "square_patch": 3,
                                 "reflection": 4, "large_angle": 5, "zero": 6}[case])
    n = 2048
    a = rng.uniform(-20, 20, (n, 3))
    if case in ("plane", "noisy_plane", "square_patch"):
        a[:, 2] = 0.0 if case != "noisy_plane" else rng.normal(0, 0.01, n)
    if case == "square_patch":
        a[:, :2] = rng.uniform(-1, 1, (n, 2))
    axis = rng.normal(size=3)
    angle = 2.5 if case == "large_angle" else 0.3
    rot = so3.exp(torch.tensor(axis / np.linalg.norm(axis) * angle))
    b = torch.tensor(a) @ rot.T + torch.tensor([1.0, -2.0, 0.5], dtype=torch.float64)
    if case == "reflection":
        b = b * torch.tensor([1.0, 1.0, -1.0], dtype=torch.float64)
    h = _cross_cov(torch.tensor(a), b).float() * (0.0 if case == "zero" else 1.0)
    got = cl.kabsch_rotation(h)
    assert float(np.abs(got.numpy() - _jax_kabsch(h.numpy())).max()) < 1e-5
    assert abs(float(torch.linalg.det(got)) - 1.0) < 1e-5


def _known_pair(n=1024, ang=0.1, t=(0.4, -0.2, 0.1), seed=0, noise=0.01):
    """A structured cloud and its rigid motion with `noise` m of sensor
    noise (a noise-free pair has a fitness at the f32 floor, where relative
    tolerances mean nothing)."""
    pts = _structured_cloud(n)
    c, s = np.cos(ang), np.sin(ang)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    noise = np.random.default_rng(seed).normal(0, noise, pts.shape)
    return pts, (pts @ rot.T + np.float32(t) + noise).astype(np.float32)


def _icp_cases(case):
    if case == "known_transform":
        src, tgt = _known_pair()
        return (src, np.ones(len(src), bool)), (tgt, np.ones(len(tgt), bool)), 5.0, 50
    if case == "padding":
        pts, tgt = _known_pair(512, 0.0, (0.0, 0.0, 0.0))
        xyz = np.zeros((1024, 3), np.float32)
        xyz[:512], xyz[512:] = pts, 1e6  # poisoned padding
        return (xyz, np.arange(1024) < 512), (tgt, np.ones(512, bool)), 5.0, 30
    # world-scale coordinates, 25-40 m from the origin (the loop path's
    # regime) with 3 cm of noise: there the matmul-form distance's ~1e-4 m^2
    # of cancellation picks among near-tied neighbours, which moved the
    # reference's own fitness by 9e-4 relative between iteration counts on
    # a 1 cm-noise pair
    src, tgt = _known_pair(2048, 0.05, (0.3, 0.2, 0.0), noise=0.03)
    return ((src + 25.0).astype(np.float32), np.ones(2048, bool)), \
        ((tgt + 25.0).astype(np.float32), np.ones(2048, bool)), 10.0, 100


def _close_icp(got, want):
    assert bool(got.converged) == bool(want.converged)
    assert rot_diff_rad(got.rot.numpy(), np.asarray(want.rot)) < ICP_ROT_RAD
    assert np.linalg.norm(got.trans.numpy() - np.asarray(want.trans)) < ICP_TRANS_M
    np.testing.assert_allclose(float(got.fitness), float(want.fitness), rtol=FITNESS_REL)


@pytest.mark.parametrize("case", ["known_transform", "padding", "world_scale"])
def test_icp_matches_reference(case):
    (sx, sm), (tx, tm), corr, iters = _icp_cases(case)
    want = jcl.icp_point2point(_jcloud(sx, sm), _jcloud(tx, tm), jnp.eye(3), jnp.zeros(3),
                               max_corr_dist=corr, max_iterations=iters)
    got = cl.icp_point2point(PaddedCloud(T(sx), T(sm)), PaddedCloud(T(tx), T(tm)),
                             torch.eye(3), torch.zeros(3), max_corr_dist=corr,
                             max_iterations=iters)
    _close_icp(got, want)
    assert bool(got.converged)


def test_icp_without_correspondences_is_not_converged():
    """Fewer than 3 gated correspondences: not converged in both."""
    src, tgt = _known_pair(64)
    args = (np.ones(64, bool), (tgt + 100.0).astype(np.float32))
    want = jcl.icp_point2point(_jcloud(src, args[0]), _jcloud(args[1], args[0]), jnp.eye(3),
                               jnp.zeros(3), max_corr_dist=1.0, max_iterations=5)
    got = cl.icp_point2point(PaddedCloud(T(src), T(args[0])), PaddedCloud(T(args[1]), T(args[0])),
                             torch.eye(3), torch.zeros(3), max_corr_dist=1.0, max_iterations=5)
    assert not bool(got.converged) and not bool(want.converged)
    np.testing.assert_allclose(float(got.fitness), float(want.fitness), rtol=FITNESS_REL)


@pytest.mark.parametrize("robust", [True, False])
def test_verify_loop_matches_reference(robust):
    jdb = _jax_db()
    cur = jcl.assemble_loop_submap(jdb, jnp.asarray(7), 0, 4096, 0.4)
    prev = jcl.assemble_loop_submap(jdb, jnp.asarray(0), 2, 8192, 0.4)
    want = jcl.verify_loop(jdb, jnp.asarray(7), jnp.asarray(0), cur, prev, jnp.asarray(0.05),
                           max_corr_dist=30.0 if robust else 10.0, fitness_threshold=0.3,
                           robust=robust)
    got = cl.verify_loop(_port_db(jdb), torch.tensor(7), torch.tensor(0), _cloud(cur),
                         _cloud(prev), torch.tensor(0.05), max_corr_dist=30.0 if robust else 10.0,
                         fitness_threshold=0.3, robust=robust)
    assert bool(got.accepted) == bool(want.accepted)
    assert (int(got.i), int(got.j)) == (int(want.i), int(want.j)) == (7, 0)
    assert rot_diff_rad(got.rel_rot.numpy(), np.asarray(want.rel_rot)) < ICP_ROT_RAD
    assert np.linalg.norm(got.rel_trans.numpy() - np.asarray(want.rel_trans)) < ICP_TRANS_M
    np.testing.assert_allclose(got.noise_var.numpy(), np.asarray(want.noise_var), rtol=FITNESS_REL)
    assert float(got.robust_c) == float(want.robust_c) == (1.0 if robust else 0.0)


@functools.lru_cache(maxsize=None)
def _loop_cfg(kind):
    return dataclasses.replace(SMALL, loop=dataclasses.replace(SMALL.loop, loop_close_type=kind))


def _factors(graph_loops):
    n = int(graph_loops.count)
    return [(int(graph_loops.i[k]), int(graph_loops.j[k])) for k in range(n)]


def _same_loops(got, want):
    """The same accepted factors (i, j) in the same order, measurements to
    the ICP tolerances, and the same matched keyframes and drop counts."""
    g, w = bk.backend_state_to_numpy(got), bk.backend_state_to_numpy(want)
    n = int(w["graph.loops.count"])
    assert int(g["graph.loops.count"]) == n
    for key in ("graph.loops.i", "graph.loops.j", "graph.loops.valid", "loop_matched",
                "dropped_counts", "pending_solve"):
        np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    np.testing.assert_allclose(g["graph.loops.rel_trans"][:n], w["graph.loops.rel_trans"][:n],
                               atol=ICP_TRANS_M)
    assert np.all(rot_diff_rad(g["graph.loops.rel_rot"][:n],
                               w["graph.loops.rel_rot"][:n]) < ICP_ROT_RAD)
    np.testing.assert_allclose(g["graph.loops.noise_var"][:n], w["graph.loops.noise_var"][:n],
                               rtol=FITNESS_REL)
    np.testing.assert_array_equal(g["graph.loops.robust_c"], w["graph.loops.robust_c"])


@pytest.mark.parametrize("kind", ["all", "rs"])
def test_loop_closure_step_matches_reference(kind):
    """The out-and-back return closes a loop: by scan context first under
    "all" (the radius search then finds the keyframe matched), by radius
    search under "rs"."""
    jcfg = _loop_cfg(kind)
    jstate = out_and_back(jcfg)
    want, wclosed = jbk.loop_closure_step(jstate, jcfg)
    state = bk.backend_state_from_numpy(bk.backend_state_to_numpy(jstate), "cpu")
    got, closed = bk.loop_closure_step(state, port_config(jcfg))
    assert bool(closed) == bool(wclosed)
    assert _factors(got.graph.loops) == _factors(want.graph.loops) == [(13, 0)]
    _same_loops(got, want)
    assert float(got.graph.loops.robust_c[0]) == (1.0 if kind == "all" else 0.0)
    # a second pass: scan context finds the revisit again (it does not read
    # the matched flags), radius search finds the keyframe matched
    again, _ = bk.loop_closure_step(got, port_config(jcfg))
    want_again, _ = jbk.loop_closure_step(want, jcfg)
    _same_loops(again, want_again)


@pytest.mark.parametrize("times,closes", [((13.0, 0.0), True), ((13.0, 12.0), False),
                                          ((13.0, 0.0, 13.0, 0.0), False)])
def test_external_loop_step_matches_reference(times, closes):
    """An injected pair closes; a pair closer than the time gate does not;
    the same pair twice closes once (its keyframe is then matched)."""
    jcfg = _loop_cfg("rs")
    jstate = out_and_back(jcfg)
    state = bk.backend_state_from_numpy(bk.backend_state_to_numpy(jstate), "cpu")
    for k in range(0, len(times), 2):
        jstate, wclosed = jbk.external_loop_step(jstate, jnp.float32(times[k]),
                                                 jnp.float32(times[k + 1]), jcfg)
        state, closed = bk.external_loop_step(state, times[k], times[k + 1], port_config(jcfg))
        assert bool(closed) == bool(wclosed)
    assert bool(closed) == closes
    _same_loops(state, jstate)
    assert int(state.graph.loops.count) == (0 if times == (13.0, 12.0) else 1)
