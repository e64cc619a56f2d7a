"""Device-numerics oracles of the port: the ten tests of
tests_tpu/test_tpu_numeric_oracles.py, with the same inputs and tolerances,
each holding one numeric path of the port against a float64 or exact oracle
on the device that runs it:

  - ops/knn_moments.py  K2 (moment sums of the k nearest neighbours)
  - voxel/knn.py        the moment selector against the exact selector
  - ops/linalg.py       adjugate 3x3 / unrolled 6x6 Cholesky solve_psd
  - voxel/voxelmap.py   the full-capacity duplicate-slot fast path
  - ops/voxel_join.py   K1 (keyed sum)
  - ops/eig3.py         closed-form symmetric 3x3 eigendecomposition

Each test runs on the CPU (the plain versions) and, marked `cuda`, on the
card (the CUDA kernels, whose launches it counts); the card's cases skip
without one. They import no JAX, so on the card's machine run them without
the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_oracles.py
"""

import numpy as np
import pytest
import torch

from rolo_tpu_torch.ops.eig3 import eigh3
from rolo_tpu_torch.ops.knn_moments import knn_moments
from rolo_tpu_torch.ops.linalg import solve_psd
from rolo_tpu_torch.ops.voxel_join import keyed_matmul, pack_uniform
from rolo_tpu_torch.runtime.platform import configure_precision
from rolo_tpu_torch.voxel.knn import estimate_cov6
from rolo_tpu_torch.voxel.voxelmap import build_voxel_map, lookup, uniform_coord


@pytest.fixture(params=["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def device(request):
    if request.param == "cuda":
        if not torch.cuda.is_available():
            pytest.skip("needs a CUDA device and nvcc")
        configure_precision()
    return torch.device(request.param)


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def _lidar_cloud(rng, n, spread=0.5, lo=20.0, hi=50.0):
    return (rng.normal(size=(n, 3)) * spread + rng.uniform(lo, hi, size=(n, 1))).astype(
        np.float32)


def _on(device, *arrays):
    """Each numpy array as a contiguous tensor with a batch of one on
    `device`."""
    return [torch.as_tensor(a, device=device)[None].contiguous() for a in arrays]


def _launched(fn, device):
    """fn()'s result on the host; on the card, raises unless fn launched
    its kernel (`fn` is a wrapper with a launch counter)."""
    def run(*args, **kwargs):
        before = fn.launches
        out = fn(*args, **kwargs)
        if device.type == "cuda":
            torch.cuda.synchronize()
            assert fn.launches > before, f"{fn.__name__} did not launch its kernel"
        return out[0].cpu().numpy()

    return run


# ---------------------------------------------------------------- knn_moments


def _moment_table(xyz, mask):
    n = xyz.shape[0]
    xc = np.concatenate(
        [np.ones((n, 1), np.float32), xyz, xyz[:, :1] * xyz,
         xyz[:, 1:2] * xyz[:, 1:], xyz[:, 2:] * xyz[:, 2:]], axis=1
    ) * mask[:, None]
    return np.pad(xc.T, ((0, 6), (0, 0))).astype(np.float32)


def test_knn_moments_matches_f64_oracle(rng, device):
    n, k = 1024, 20
    xyz = _lidar_cloud(rng, n)
    mask = rng.random(n) < 0.9
    xyz_z = np.where(mask[:, None], xyz, 0.0).astype(np.float32)
    got = _launched(knn_moments, device)(*_on(device, xyz_z, mask, xyz_z, mask,
                                              _moment_table(xyz_z, mask)), k)
    d2 = ((xyz_z[:, None, :].astype(np.float64) - xyz_z[None, :, :].astype(np.float64)) ** 2
          ).sum(-1)
    d2[:, ~mask] = np.inf
    xc64 = _moment_table(xyz_z, mask).astype(np.float64)
    same = 0
    for i in np.where(mask)[0]:
        rk = np.sort(d2[i])[k - 1]
        w = d2[i] <= rk
        want_i = xc64[:, w].sum(axis=1)
        if got[0, i] == w.sum():
            same += 1
            np.testing.assert_allclose(got[:, i], want_i, rtol=1e-5, atol=1e-3)
    # the bisection slack admits an extra boundary tie on at most a few
    # queries; membership must be exactly the true k-NN set on >= 95%
    assert same / mask.sum() > 0.95


def test_knn_moments_membership_radius_is_tight(rng, device):
    """The count must be k (+ ties), never inflated; the means catch member
    swaps that a count check would miss."""
    n, k = 2048, 20
    xyz = _lidar_cloud(rng, n)
    mask = np.ones(n, bool)
    got = _launched(knn_moments, device)(*_on(device, xyz, mask, xyz, mask,
                                              _moment_table(xyz, mask)), k)
    cnt = got[0]
    assert cnt.min() >= k and cnt.max() <= k + 2
    d2 = ((xyz[:, None, :].astype(np.float64) - xyz[None, :, :].astype(np.float64)) ** 2).sum(-1)
    idx = np.argsort(d2, axis=1)[:, :k]
    mu_ex = xyz[idx].mean(axis=1)
    mu_k = (got[1:4] / cnt).T
    err = np.linalg.norm(mu_k - mu_ex, axis=1)
    # a membership scramble puts the median near 3e-2
    assert np.median(err) < 1e-4


# ----------------------------------------------------------- moment selector


def _cov6(xyz, mask, device, **kwargs):
    x, m = _on(device, xyz, mask)
    return estimate_cov6(x, m, **kwargs)[0].cpu().numpy()


def test_moment_selector_matches_exact_selector(rng, device):
    """The production covariance path (the moment selector, K2 on the card)
    against the exact top-k gather selector, before regularization."""
    n, k = 4096, 20
    xyz = _lidar_cloud(rng, n)
    mask = rng.random(n) < 0.85
    c_mom = _cov6(xyz, mask, device, k=k, method="none", selector="moment")
    c_ex = _cov6(xyz, mask, device, k=k, method="none", selector="exact")
    diff = np.abs(c_mom - c_ex).max(axis=0)[mask]
    scale = np.abs(c_ex).max(axis=0)[mask] + 1e-9
    rel = diff / scale
    # E[xx] - mu mu^T carries an f32 cancellation at lidar coordinate scale
    # (~6% median); the bound pins it so a precision loss fails loudly
    assert np.median(rel) < 0.10
    assert np.percentile(rel, 90) < 0.40


def test_moment_selector_post_plane_regularization(rng, device):
    """After PLANE regularization (the production method) the entries are
    O(1) plane orientations that the cancellation perturbs by ~0.07."""
    n, k = 4096, 20
    xyz = _lidar_cloud(rng, n)
    mask = np.ones(n, bool)
    c_mom = _cov6(xyz, mask, device, k=k, method="plane", selector="moment")
    c_ex = _cov6(xyz, mask, device, k=k, method="plane", selector="exact")
    diff = np.abs(c_mom - c_ex).max(axis=0)
    assert np.median(diff) < 0.15
    assert (diff > 0.8).mean() < 0.05


# ------------------------------------------------------------------ solve_psd


@pytest.mark.parametrize("b,n,median_tol", [(4096, 3, 1e-5), (2048, 6, 1e-4)],
                         ids=["3x3_adjugate", "6x6_unrolled_cholesky"])
def test_solve_psd_vs_f64(rng, device, b, n, median_tol):
    a = rng.normal(size=(b, n, n))
    h = (a @ a.transpose(0, 2, 1) + 1e-2 * np.eye(n)).astype(np.float32)
    rhs = rng.normal(size=(b, n)).astype(np.float32)
    x = solve_psd(torch.as_tensor(h, device=device), torch.as_tensor(rhs, device=device))
    x = x.cpu().numpy()
    x64 = np.linalg.solve(h.astype(np.float64), rhs.astype(np.float64)[..., None])[..., 0]
    rel = np.linalg.norm(x - x64, axis=1) / (np.linalg.norm(x64, axis=1) + 1e-12)
    assert np.median(rel) < median_tol
    assert rel.max() < 1e-2  # the worst conditioned entries


# ------------------------------------------------------------- voxel map build


def test_voxelmap_fullcap_fast_path_vs_truncating_path(rng, device):
    """capacity >= N takes the duplicate-slot fast path, capacity < N the
    compacting path; the stats seen through lookup() must agree."""
    n = 1024
    xyz = (rng.normal(size=(n, 3)) * 3.0).astype(np.float32)
    mask = rng.random(n) < 0.9
    cov6 = np.tile(np.array([1, 0, 0, 1, 0, 1], np.float32)[:, None], (1, n))
    xj, cj, mj = _on(device, xyz, cov6, mask)
    vm_fast = build_voxel_map(xj, cj, mj, capacity=2048, resolution=2.0)
    vm_slow = build_voxel_map(xj, cj, mj, capacity=512, resolution=2.0)
    n_vox = int(vm_fast.valid.sum())
    assert n_vox < 512, "test scene too dense for the truncating table"
    coord = uniform_coord(torch.as_tensor(xyz[:256], device=device)[None], 2.0)
    fast = [v[0].cpu().numpy() for v in lookup(vm_fast, coord, polar=False)]
    slow = [v[0].cpu().numpy() for v in lookup(vm_slow, coord, polar=False)]
    np.testing.assert_array_equal(fast[0], slow[0])
    np.testing.assert_allclose(fast[1], slow[1], rtol=1e-6)
    np.testing.assert_allclose(fast[2], slow[2], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(fast[3], slow[3], rtol=1e-5, atol=1e-5)


def test_voxelmap_fullcap_stats_vs_numpy_oracle(rng, device):
    n = 768
    xyz = (rng.normal(size=(n, 3)) * 3.0).astype(np.float32)
    mask = rng.random(n) < 0.85
    cov6 = rng.normal(size=(6, n)).astype(np.float32)
    vm = build_voxel_map(*_on(device, xyz, cov6, mask), capacity=1024, resolution=1.0)
    pack_np = pack_uniform(uniform_coord(torch.as_tensor(xyz), 1.0)).numpy()
    pack_np = np.where(mask, pack_np, np.iinfo(np.int32).max)
    table, valid, num, mean, c6 = (t[0].cpu().numpy() for t in (vm.pack, vm.valid,
                                                               vm.num_points, vm.mean, vm.cov6))
    for s in np.where(valid)[0]:
        members = pack_np == table[s]
        assert members.sum() == num[s]
        np.testing.assert_allclose(mean[:, s], xyz[members].mean(axis=0), rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(c6[:, s], cov6[:, members].mean(axis=1), rtol=1e-4,
                                   atol=1e-4)


# --------------------------------------------------------------- keyed matmul


def test_keyed_matmul_vs_f64(rng, device):
    s, n, v = 10, 4096, 512
    vals = (rng.normal(size=(s, n)) * 30.0).astype(np.float32)
    keys = rng.integers(0, 400, size=n).astype(np.int32)
    table = np.arange(v, dtype=np.int32)
    got = _launched(keyed_matmul, device)(*_on(device, vals, keys, table))
    want = np.zeros((s, v))
    for j in range(v):
        want[:, j] = vals[:, keys == table[j]].astype(np.float64).sum(axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


# ----------------------------------------------------------------------- eig3


def test_eigh3_vs_numpy(rng, device):
    b = 4096
    a = rng.normal(size=(b, 3, 3))
    m = (a @ a.transpose(0, 2, 1)).astype(np.float32)
    w, vec = (t.cpu().numpy() for t in eigh3(torch.as_tensor(m, device=device)))
    w64 = np.linalg.eigvalsh(m.astype(np.float64))
    np.testing.assert_allclose(w, w64, rtol=1e-3, atol=1e-3)
    # the eigenvector property: M v = lambda v
    mv = np.einsum("bij,bjk->bik", m, vec)
    lv = w[:, None, :] * vec
    assert np.abs(mv - lv).max() < 5e-2
