"""Parity of the port's mapping layer with the JAX reference: the
whole-cloud voxel downsample and compaction, the keyframe DB and submap
extraction, the scan-to-submap binds and GN solve (with and without the
candidate set), and the interpolating median of the candidate radius."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import T, point_set_match

from rolo_tpu.geometry import so3 as jso3
from rolo_tpu.geometry.se3 import SE3 as JSE3
from rolo_tpu.mapping import keyframes as jkf
from rolo_tpu.mapping import scan2map as js2m
from rolo_tpu.pointcloud import cloud as jcloud
from rolo_tpu.pointcloud.features import voxel_downsample as jvoxel_downsample

from rolo_tpu_torch.geometry import so3
from rolo_tpu_torch.geometry.se3 import SE3
from rolo_tpu_torch.mapping import keyframes as kf
from rolo_tpu_torch.mapping import scan2map as s2m
from rolo_tpu_torch.pointcloud.cloud import PaddedCloud, compact_cloud
from rolo_tpu_torch.pointcloud.features import voxel_downsample

TRUE_RPY = np.array([0.01, -0.02, 0.05], np.float32)
TRUE_XYZ = np.array([0.3, -0.2, 0.1], np.float32)
# The plane fit solves the 5-point normal equations A^T A n = -A^T 1 with
# the neighbours ~10 m from the origin: the plane's orientation lives in
# ~1e-4 variations of entries ~3e2 (5 mm noise against |p|^2), so f32
# rounding differences in A^T A (einsum in one package, bmm in the other)
# move the fitted offset by up to ~8% and flip the 0.2 m plane gate for a few
# percent of the surface points. The GN solutions then agree to ~4e-4 rad
# and ~4 mm (and each lies that close to the truth); the iteration count at
# which the 0.5 mm stopping test fires differs.
RPY_TOL, XYZ_TOL = 1e-3, 1e-2


@functools.lru_cache(maxsize=None)
def _scene():
    """Floor, two walls and three vertical edges (a structured submap), and
    the scan of it from the true pose, sensor frame."""
    rng = np.random.default_rng(21)
    m = 1000
    surf = np.concatenate([
        np.stack([rng.uniform(-10, 10, m), rng.uniform(-10, 10, m), np.zeros(m)], -1),
        np.stack([np.full(m, 8.0), rng.uniform(-10, 10, m), rng.uniform(0, 4, m)], -1),
        np.stack([rng.uniform(-10, 10, m), np.full(m, 9.0), rng.uniform(0, 4, m)], -1),
    ]).astype(np.float32)
    surf += rng.normal(0, 0.005, surf.shape).astype(np.float32)
    z = np.linspace(0, 4, 120)
    corner = np.concatenate([np.stack([np.full_like(z, x), np.full_like(z, y), z], -1)
                             for x, y in [(8.0, 9.0), (8.0, -4.0), (-3.0, 9.0)]]).astype(np.float32)
    corner += rng.normal(0, 0.004, corner.shape).astype(np.float32)
    r = np.asarray(jso3.rpy_to_matrix(*[jnp.asarray(v) for v in TRUE_RPY]))
    return (surf, corner, ((surf[::3] - TRUE_XYZ) @ r).astype(np.float32),
            ((corner[::2] - TRUE_XYZ) @ r).astype(np.float32))


def _clouds(module):
    surf, corner, surf_scan, corner_scan = _scene()
    make = module.PaddedCloud.from_points
    return make(corner_scan, 256), make(surf_scan, 2048), make(corner, 512), make(surf, 4096)


def _port(c):
    return PaddedCloud(T(c.xyz), T(c.mask))


def test_voxel_downsample_whole_cloud_matches_reference():
    """The repaired fault: the whole-cloud path (ring_id=None) failed."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-20, 20, (3000, 3)).astype(np.float32)
    pts[1000:1500] = pts[:500] + rng.normal(0, 0.02, (500, 3)).astype(np.float32)
    mask = rng.random(3000) < 0.9
    pts[~mask] = np.nan
    for leaf, cap in [(0.4, 4096), (0.4, 600), (2.0, 4096)]:
        want = jvoxel_downsample(jcloud.PaddedCloud(jnp.asarray(pts), jnp.asarray(mask)), leaf, cap)
        got = voxel_downsample(PaddedCloud(T(pts), T(mask)), leaf, cap)
        # same hash order and segments: slot for slot, centroid sums in f32
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
        np.testing.assert_allclose(got.xyz.numpy(), np.asarray(want.xyz), atol=1e-5)


def test_compact_cloud_and_from_points_match_reference():
    rng = np.random.default_rng(1)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    want, got = jcloud.PaddedCloud.from_points(pts, 64), PaddedCloud.from_points(pts, 64, "cpu")
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))
    np.testing.assert_array_equal(got.to_numpy(), want.to_numpy())
    mask = rng.random(64) < 0.5
    jc = jcloud.compact_cloud(jcloud.PaddedCloud(want.xyz, jnp.asarray(mask)))
    tc = compact_cloud(PaddedCloud(got.xyz, T(mask)))
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    np.testing.assert_array_equal(tc.xyz.numpy(), np.asarray(jc.xyz))


def _dbs(n=6):
    """The same keyframe DB in both packages: poses along x, random clouds."""
    rng = np.random.default_rng(2)
    jdb = jkf.init_db(16, 64, 128)
    db = kf.init_db(16, 64, 128, "cpu")
    for i in range(n):
        rot = np.asarray(jso3.rpy_to_matrix(jnp.asarray(0.0), jnp.asarray(0.0),
                                            jnp.asarray(0.1 * i)))
        trans = np.array([i * 3.0, 0.5 * i, 0.0], np.float32)
        pts = rng.uniform(-4, 4, (100, 3)).astype(np.float32)
        jc, js = jcloud.PaddedCloud.from_points(pts[:40], 64), jcloud.PaddedCloud.from_points(pts, 128)
        jdb = jkf.add_keyframe(jdb, JSE3(jnp.asarray(rot), jnp.asarray(trans)),
                               jnp.asarray(float(i)), jc, js)
        db = kf.add_keyframe(db, SE3(T(rot), T(trans)), float(i), _port(jc), _port(js))
    return jdb, db


def test_keyframe_db_and_gate_match_reference():
    jdb, db = _dbs()
    for field in kf.KeyframeDB._fields:
        np.testing.assert_array_equal(getattr(db, field).numpy(), np.asarray(getattr(jdb, field)),
                                      err_msg=field)
    for trans in ([15.2, 2.5, 0.0], [16.0, 2.5, 0.0]):
        for yaw in (0.5, 0.8):
            rot = np.asarray(jso3.rpy_to_matrix(jnp.asarray(0.0), jnp.asarray(0.0),
                                                jnp.asarray(yaw)))
            want = bool(jkf.should_add_keyframe(jdb, JSE3(jnp.asarray(rot), jnp.asarray(trans)),
                                                0.5, 0.2))
            got = bool(kf.should_add_keyframe(db, SE3(T(rot), T(np.float32(trans))), 0.5, 0.2))
            assert got == want
    # a full DB drops, and counts stay put
    full = kf.init_db(2, 8, 8, "cpu")
    c = PaddedCloud.from_points(np.zeros((3, 3)), 8, "cpu")
    for _ in range(3):
        full = kf.add_keyframe(full, SE3.identity(), 0.0, c, c)
    assert int(full.count) == 2


@pytest.mark.parametrize("query,time,max_nearby", [((0.0, 0.0, 0.0), 100.0, 8),
                                                   ((7.0, 1.0, 0.0), 4.5, 3)])
def test_extract_submap_matches_reference(query, time, max_nearby):
    """Ineligible keyframes tie at inf in the top-k and may be picked in
    another order; they are masked, so the masked submaps are compared."""
    jdb, db = _dbs()
    kw = dict(search_radius=6.0, recency_sec=1.5, max_nearby=max_nearby, corner_out_cap=512,
              surf_out_cap=1024, corner_leaf=0.05, surf_leaf=0.3)
    want = jkf.extract_submap(jdb, jnp.asarray(query), jnp.asarray(time), **kw)
    got = kf.extract_submap(db, T(np.float32(query)), time, **kw)
    for g, w in zip(got, want):
        gp, wp = PaddedCloud(g.xyz, g.mask).to_numpy(), w.to_numpy()
        assert len(gp) == len(wp) > 0
        assert point_set_match(gp, wp, 1e-5) == 1.0


@functools.lru_cache(maxsize=None)
def _jax_s2m(n_candidates, start):
    cp, sp, sc, ss = _clouds(jcloud)
    rpy0, xyz0 = start
    return js2m.scan2map_optimize(jnp.asarray(rpy0), jnp.asarray(xyz0), cp.xyz, cp.mask, sp.xyz,
                                  sp.mask, sc, ss, max_iterations=12, chunk=256,
                                  approx_knn=True, n_candidates=n_candidates)


STARTS = {
    "zero": ((0.0, 0.0, 0.0), (0.0, 0.0, 0.0)),
    # ~0.7 m off: the GN moves past the bind-time candidate radius, so the
    # stale-candidate guard re-runs the full search
    "far": (tuple(TRUE_RPY.tolist()), tuple((TRUE_XYZ + [0.5, -0.45, 0.0]).tolist())),
}


@pytest.mark.parametrize("n_candidates,start", [(0, "zero"), (16, "zero"), (16, "far")])
def test_scan2map_optimize_matches_reference(n_candidates, start):
    cp, sp, sc, ss = (_port(c) for c in _clouds(jcloud))
    rpy0, xyz0 = STARTS[start]
    want = _jax_s2m(n_candidates, STARTS[start])
    got = s2m.scan2map_optimize(T(np.float32(rpy0)), T(np.float32(xyz0)), cp.xyz, cp.mask, sp.xyz,
                                sp.mask, sc, ss, max_iterations=12, chunk=256, approx_knn=True,
                                n_candidates=n_candidates)
    np.testing.assert_allclose(got.rpy.numpy(), np.asarray(want.rpy), atol=RPY_TOL)
    np.testing.assert_allclose(got.trans.numpy(), np.asarray(want.trans), atol=XYZ_TOL)
    assert bool(got.degenerate) == bool(want.degenerate)
    assert abs(int(got.num_factors) - int(want.num_factors)) <= 0.02 * int(want.num_factors)
    assert 1 <= int(got.iterations) <= 12
    # both recover the true pose (the bound of tests/test_mapping.py)
    np.testing.assert_allclose(got.rpy.numpy(), TRUE_RPY, atol=3e-3)
    np.testing.assert_allclose(got.trans.numpy(), TRUE_XYZ, atol=3e-2)


@pytest.mark.parametrize("with_candidates", [False, True])
def test_binds_match_reference(with_candidates):
    jcp, jsp, jsc, jss = _clouds(jcloud)
    cp, sp, sc, ss = (_port(c) for c in (jcp, jsp, jsc, jss))
    rot = np.asarray(jso3.rpy_to_matrix(*[jnp.asarray(v) for v in TRUE_RPY * 0.5]))
    trans = TRUE_XYZ * 0.5
    jcand = tcand = (None, None)
    if with_candidates:
        jcand = tuple(js2m.nn_candidates(p.xyz, p.mask, s, jnp.asarray(rot), jnp.asarray(trans), 16,
                                         256)[0] for p, s in ((jcp, jsc), (jsp, jss)))
        tcand = tuple(s2m.nn_candidates(p.xyz, p.mask, s, T(rot), T(trans), 16, 256)[0]
                      for p, s in ((cp, sc), (sp, ss)))
    jcb = js2m.corner_bind(jcp.xyz, jcp.mask, jsc, jnp.asarray(rot), jnp.asarray(trans), 256,
                           cand_idx=jcand[0])
    cb = s2m.corner_bind(cp.xyz, cp.mask, sc, T(rot), T(trans), 256, cand_idx=tcand[0])
    jsb = js2m.surf_bind(jsp.xyz, jsp.mask, jss, jnp.asarray(rot), jnp.asarray(trans), 256,
                         cand_idx=jcand[1])
    sb = s2m.surf_bind(sp.xyz, sp.mask, ss, T(rot), T(trans), 256, cand_idx=tcand[1])
    v, jv = cb.valid.numpy(), np.asarray(jcb.valid)
    np.testing.assert_array_equal(v, jv)  # corners: the same lines
    assert v.sum() > 50
    np.testing.assert_allclose(cb.center.numpy()[v], np.asarray(jcb.center)[v], atol=1e-5)
    dots = np.abs(np.sum(cb.u.numpy() * np.asarray(jcb.u), axis=-1))[v]
    assert np.all(dots > 1 - 1e-5)
    # surfaces: the f32 plane fit (see RPY_TOL) flips a few gates and moves
    # normals and offsets by up to a few percent
    v, jv = sb.valid.numpy(), np.asarray(jsb.valid)
    assert (v == jv).mean() > 0.95 and v.sum() > 500
    both = v & jv
    dots = np.abs(np.sum(sb.pa.numpy() * np.asarray(jsb.pa), axis=-1))[both]
    rel_pd = np.abs(sb.pd.numpy() / np.asarray(jsb.pd) - 1.0)[both]
    assert np.quantile(1 - dots, 0.99) < 2e-2 and np.quantile(rel_pd, 0.99) < 5e-2


def test_candidate_radius_interpolates_the_median():
    """`jnp.nanmedian` averages the two middle values where `torch.nanmedian`
    takes the lower: an even count of valid points, far-neighbour distances
    1, 2, 3, 4 -> 2.5; no valid point -> 1.0."""
    pts = np.zeros((6, 3), np.float32)
    pts[:, 0] = [0.0, 10.0, 20.0, 30.0, 40.0, 50.0]
    # with n_cand=1 the farthest candidate is the nearest submap point: put
    # one at distance 1, 2, 3, 4 from points 0-3 and mask points 4-5
    near = np.stack([pts[0] + [1.0, 0, 0], pts[1] + [0, 2.0, 0], pts[2] + [0, 0, 3.0],
                     pts[3] + [0, 4.0, 0]]).astype(np.float32)
    mask = np.array([True, True, True, True, False, False])
    sub_c = jcloud.PaddedCloud.from_points(near, 8)
    eye = np.eye(3, dtype=np.float32)
    zero = np.zeros(3, np.float32)
    _, want = js2m.nn_candidates(jnp.asarray(pts), jnp.asarray(mask), sub_c, jnp.asarray(eye),
                                 jnp.asarray(zero), 1, 8)
    _, got = s2m.nn_candidates(T(pts), T(mask), _port(sub_c), T(eye), T(zero), 1, 8)
    assert float(want) == pytest.approx(2.5)
    assert float(got) == pytest.approx(2.5)
    assert float(torch.nanmedian(torch.tensor([1.0, 2.0, 3.0, 4.0]))) == 2.0  # the trap
    _, empty = s2m.nn_candidates(T(pts), T(np.zeros(6, bool)), _port(sub_c), T(eye), T(zero), 1, 8)
    assert float(empty) == 1.0


def test_constrain_transform_and_rpy_jacobian_match_reference():
    rpy = np.array([0.3, -1.2, 2.9], np.float32)
    xyz = np.array([1.0, 2.0, -3.0], np.float32)
    want = js2m.constrain_transform(jnp.asarray(rpy), jnp.asarray(xyz), 0.1, 0.5)
    got = s2m.constrain_transform(T(rpy), T(xyz), 0.1, 0.5)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    _, jdr = js2m._rpy_matrices(jnp.asarray(rpy))
    np.testing.assert_allclose(s2m._rpy_jacobian(T(rpy)).numpy(), np.asarray(jdr), atol=1e-6)
    np.testing.assert_allclose(torch.stack(so3.matrix_to_rpy(so3.rpy_to_matrix(*T(rpy)))).numpy(),
                               rpy, atol=1e-5)
