"""Parity of the port's voxel layer with the JAX reference: per-point
covariances (exact and moment selectors), the voxel-map build and the join
(kernel K1's plain version), and the voxel hash."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import T, lidar_cloud

from rolo_tpu.ops import sym3 as jsym3
from rolo_tpu.ops.knn_moments import knn_moments as jknn_moments
from rolo_tpu.voxel import knn as jknn
from rolo_tpu.voxel import voxelmap as jvm
from rolo_tpu.ops.voxel_join import pack_polar as jpack_polar, pack_uniform as jpack_uniform

from rolo_tpu_torch.ops.voxel_join import pack_polar, pack_uniform
from rolo_tpu_torch.voxel import knn, voxelmap as vm

POLAR = (0.175, 0.175, 2.0)


def _scene_points(rng, n=1536, valid_frac=0.9):
    """Lidar-like features: planes and clusters at 5-40 m, masked tail."""
    pts = np.concatenate([
        lidar_cloud(rng, n // 2, spread=0.8, lo=5.0, hi=40.0),
        np.column_stack([rng.uniform(-30, 30, n - n // 2), rng.uniform(-30, 30, n - n // 2),
                         np.full(n - n // 2, -1.7) + rng.normal(0, 0.02, n - n // 2)]),
    ]).astype(np.float32)
    mask = rng.random(n) < valid_frac
    pts[~mask] = np.nan  # padding garbage the port must zero, as the reference does
    return pts, mask


def test_estimate_cov6_exact_matches_reference():
    rng = np.random.default_rng(0)
    pts, mask = _scene_points(rng, 768)
    want = np.asarray(jknn.estimate_cov6(jnp.asarray(pts), jnp.asarray(mask), k=10,
                                         selector="exact"))
    got = knn.estimate_cov6(T(pts)[None], T(mask)[None], k=10, selector="exact")[0].numpy()
    # same neighbours, same formula: f32 round-off through the eigenvector
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
    np.testing.assert_array_equal(got[:, ~mask], want[:, ~mask])


def _jax_moment_cov6(pts, mask, k):
    """The reference's K2 composition: knn_moments + knn.py:294-311."""
    x = np.where(mask[:, None], pts, 0.0).astype(np.float32)
    xc = np.concatenate([np.ones((len(x), 1), np.float32), x, x[:, :1] * x, x[:, 1:2] * x[:, 1:],
                         x[:, 2:] * x[:, 2:]], 1) * mask[:, None]
    xc16 = np.pad(xc.T, ((0, 6), (0, 0))).astype(np.float32)
    mom = jknn_moments(jnp.asarray(x), jnp.asarray(mask), jnp.asarray(x), jnp.asarray(mask),
                       jnp.asarray(xc16), k, interpret=True)
    cnt = jnp.maximum(mom[0], 1.0)
    mu = mom[1:4] / cnt
    exx = mom[4:10] / cnt
    cov6 = jnp.stack([exx[0] - mu[0] * mu[0], exx[1] - mu[0] * mu[1], exx[2] - mu[0] * mu[2],
                      exx[3] - mu[1] * mu[1], exx[4] - mu[1] * mu[2], exx[5] - mu[2] * mu[2]],
                     0) * (cnt / float(k))
    cov6 = jsym3.plane_regularize(cov6)
    return np.asarray(jnp.where(jnp.asarray(mask)[None], cov6, jsym3.identity_like(cov6)))


def test_estimate_cov6_moment_matches_reference_kernel_composition():
    rng = np.random.default_rng(1)
    pts, mask = _scene_points(rng, 1024)
    want = _jax_moment_cov6(pts, mask, 20)
    got = knn.estimate_cov6(T(pts)[None], T(mask)[None], k=20)[0].numpy()
    assert np.isfinite(got).all()
    # PLANE output I - (1-eps) q q^T: entries compare the normals. The
    # E[xx] - mu mu^T cancellation makes near-isotropic neighbourhoods
    # sensitive to summation order, so hold most points tight.
    close = np.all(np.abs(got - want) < 1e-3, axis=0)
    assert close[mask].mean() > 0.97


def test_moment_selector_tracks_exact_selector():
    """The bisection membership is a radius superset of the k-NN: the
    regularized normals mostly agree with the exact selector's."""
    rng = np.random.default_rng(2)
    pts, mask = _scene_points(rng, 1024)
    exact = knn.estimate_cov6(T(pts)[None], T(mask)[None], k=20, selector="exact")[0]
    moment = knn.estimate_cov6(T(pts)[None], T(mask)[None], k=20)[0]
    close = (torch.abs(exact - moment) < 0.05).all(dim=0)
    assert float(close[T(mask)].float().mean()) > 0.8


def _eye6(n):
    return np.broadcast_to(np.array([1.0, 0, 0, 1.0, 0, 1.0], np.float32)[:, None], (6, n)).copy()


@pytest.mark.parametrize("polar,capacity", [(True, 4096), (False, 4096), (False, 256)])
def test_build_voxel_map_matches_reference(polar, capacity):
    rng = np.random.default_rng(3)
    pts, mask = _scene_points(rng, 1536)
    pts = np.where(mask[:, None], pts, 0.0).astype(np.float32)
    cov = _eye6(1536) * rng.uniform(0.5, 2.0, 1536).astype(np.float32)
    kw = dict(polar_res=jnp.asarray(POLAR)) if polar else dict(polar_res=None, resolution=0.5)
    jm = jvm.build_voxel_map(jnp.asarray(pts), jnp.asarray(cov), jnp.asarray(mask), capacity, **kw)
    kw = dict(polar_res=POLAR) if polar else dict(polar_res=None, resolution=0.5)
    tm = vm.build_voxel_map(T(pts)[None], T(cov)[None], T(mask)[None], capacity, **kw)
    jpack, tpack = np.asarray(jm.pack), tm.pack[0].numpy()
    # per-point bins may differ on a bin boundary (atan2/acos ulps between
    # XLA:CPU and torch): compare the voxels both builds hold
    jv = {int(p): i for i, p in enumerate(jpack) if jm.valid[i]}
    tv = {int(p): i for i, p in enumerate(tpack) if tm.valid[0, i]}
    common = set(jv) & set(tv)
    assert len(common) >= 0.99 * max(len(jv), len(tv))
    same = [c for c in common if float(jm.num_points[jv[c]]) == float(tm.num_points[0, tv[c]])]
    assert len(same) >= 0.99 * len(common)
    ji = np.array([jv[c] for c in same])
    ti = np.array([tv[c] for c in same])
    np.testing.assert_allclose(tm.stats[0].numpy()[:, ti], np.asarray(jm.stats)[:, ji],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm.kappa[0].numpy()[ti], np.asarray(jm.kappa)[ji],
                               rtol=1e-4, atol=1e-5)
    assert np.all(np.diff(tpack.astype(np.int64)) >= 0)  # ascending for the binary search


@pytest.mark.parametrize("polar", [True, False])
def test_lookup_join_matches_binary_search_and_reference(polar):
    rng = np.random.default_rng(4)
    pts, mask = _scene_points(rng, 1536)
    pts = np.where(mask[:, None], pts, 0.0).astype(np.float32)
    cov = _eye6(1536)
    kw = dict(polar_res=POLAR) if polar else dict(polar_res=None, resolution=1.0)
    tm = vm.build_voxel_map(T(pts)[None], T(cov)[None], T(mask)[None], 4096, **kw)
    q = np.concatenate([pts[:512], pts[:512] + 7.0]).astype(np.float32)
    coord = vm.polar_coord(T(q), POLAR) if polar else vm.uniform_coord(T(q), 1.0)
    f1, n1, m1, c1 = vm.lookup(tm, coord[None], polar=polar)
    pack = pack_polar(coord) if polar else pack_uniform(coord)
    f2, n2, m2, c2 = vm.lookup_join(tm, pack[None])
    torch.testing.assert_close(f1, f2)
    torch.testing.assert_close(n1, n2)
    torch.testing.assert_close(m1, m2.transpose(1, 2), rtol=0, atol=1e-5)
    # against the reference join on the reference's own table of the same points
    jkw = dict(polar_res=jnp.asarray(POLAR)) if polar else dict(polar_res=None, resolution=1.0)
    jm = jvm.build_voxel_map(jnp.asarray(pts), jnp.asarray(cov), jnp.asarray(mask), 4096, **jkw)
    jpack = jpack_polar(jnp.asarray(coord.numpy())) if polar else \
        jpack_uniform(jnp.asarray(coord.numpy()))
    jf, jn, jmean, _ = jvm.lookup_join(jm, jpack)
    agree = np.asarray(jn) == n2[0].numpy()
    assert agree.mean() > 0.99
    np.testing.assert_allclose(m2[0].numpy()[:, agree], np.asarray(jmean)[:, agree], atol=1e-5)


def test_hash_coord_matches_reference_uint32():
    rng = np.random.default_rng(5)
    coord = rng.integers(-2**31, 2**31 - 1, (4096, 3), dtype=np.int64).astype(np.int32)
    coord[:100] = rng.integers(-300, 300, (100, 3))
    salt = rng.integers(0, 64, 4096).astype(np.int32)
    for s in (None, salt):
        want = np.asarray(jvm.hash_coord(jnp.asarray(coord),
                                         None if s is None else jnp.asarray(s)))
        got = vm.hash_coord(T(coord), None if s is None else T(s)).numpy()
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32 and got.min() >= 0 and got.max() < 2**30


@pytest.mark.parametrize("method", [knn.PLANE, knn.MIN_EIG])
def test_estimate_covariances_matches_reference(method):
    """The reference-shaped [N, 3, 3] wrapper (knn.py:315-324) through
    estimate_cov6's moment selector (K2's plain version here), unbatched
    and with a leading batch."""
    rng = np.random.default_rng(5)
    pts, mask = _scene_points(rng, 640)
    want = np.asarray(jknn.estimate_covariances(jnp.asarray(pts), jnp.asarray(mask), k=10,
                                                method=method))
    got = knn.estimate_covariances(T(pts), T(mask), k=10, method=method)
    assert got.shape == (640, 3, 3) and torch.isfinite(got).all()
    # as test_estimate_cov6_moment_matches_reference_kernel_composition holds
    # the same composition: near-isotropic neighbourhoods are sensitive to
    # summation order, so most points tight
    close = np.all(np.abs(got.numpy() - want) < 1e-3, axis=(1, 2))
    assert close[mask].mean() > 0.97
    assert np.array_equal(got.numpy()[~mask], want[~mask])
    both = knn.estimate_covariances(T(np.stack([pts, pts[::-1].copy()])),
                                    T(np.stack([mask, mask[::-1].copy()])), k=10, method=method)
    assert torch.equal(both[0], got)


def test_polar_origin_matches_reference():
    rng = np.random.default_rng(6)
    coord = np.stack([rng.integers(0, 36, 500), rng.integers(0, 18, 500),
                      rng.integers(0, 40, 500)], axis=-1).astype(np.int32)
    want = np.asarray(jvm.polar_origin(jnp.asarray(coord), jnp.asarray(POLAR)))
    got = vm.polar_origin(T(coord), POLAR)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    back = vm.polar_coord(got, POLAR)  # a bin center lies in its own bin
    assert torch.equal(back, T(coord))
