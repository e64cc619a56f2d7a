"""Parity of the port's closed-form 3x3 eigendecomposition (ops/eig3.py)
and covariance regularizations with the JAX reference, with
torch.linalg.eigh as the independent oracle."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import T, lidar_cloud

from rolo_tpu.ops import eig3 as jeig3
from rolo_tpu.voxel import knn as jknn

from rolo_tpu_torch.ops import eig3
from rolo_tpu_torch.voxel import knn

METHODS = ["plane", "min_eig", "normalized_min_eig", "frobenius", "none"]


def _spd_batch(rng, n=512):
    """Random covariances plus the hard cases: repeated eigenvalues
    (isotropic, plane-like, line-like) and zero eigenvalues (rank 1 and 2)."""
    a = rng.normal(size=(n, 3, 3)).astype(np.float32)
    cov = a @ np.swapaxes(a, 1, 2) * rng.uniform(1e-3, 2.0, (n, 1, 1)).astype(np.float32)
    q, _ = np.linalg.qr(rng.normal(size=(6, 3, 3)))
    special = [np.diag([2.0, 2.0, 2.0]), np.diag([1e-3, 1.0, 1.0]), np.diag([1.0, 1.0, 5.0]),
               np.diag([0.0, 0.0, 3.0]), np.diag([0.0, 1.0, 2.0]), np.zeros((3, 3))]
    special = [qi @ s @ qi.T for qi, s in zip(q, special)]
    return np.concatenate([cov, np.asarray(special, np.float32)]).astype(np.float32)


def test_eigh3_matches_reference_and_oracle():
    cov = _spd_batch(np.random.default_rng(0))
    lam, vec = eig3.eigh3(T(cov))
    jlam, jvec = jeig3.eigh3(jnp.asarray(cov))
    scale = np.abs(cov).max(axis=(1, 2))[:, None] + 1e-6
    # same formulas in f32: eigenvalues to ~1e-5 of the matrix scale
    np.testing.assert_allclose(lam.numpy() / scale, np.asarray(jlam) / scale, atol=2e-5)
    # the trigonometric solution loses up to ~1e-4 of the matrix scale on
    # the smallest eigenvalue (cancellation in q + 2p cos(phi + 2pi/3))
    olam = torch.linalg.eigvalsh(T(cov).double()).numpy()
    np.testing.assert_allclose(lam.numpy() / scale, olam / scale, atol=5e-4)
    # eigenvectors: orthonormal, and Q diag(lam) Q^T rebuilds the input
    v = vec.double()
    np.testing.assert_allclose((v.transpose(1, 2) @ v).numpy(), np.broadcast_to(np.eye(3),
                               v.shape), atol=1e-4)
    rebuilt = torch.einsum("nij,nj,nkj->nik", v, lam.double(), v).numpy()
    np.testing.assert_allclose(rebuilt / scale[:, :, None], cov / scale[:, :, None], atol=5e-4)
    # well-separated spectra: each eigenvector matches the reference up to sign
    gap = np.min(np.diff(olam, axis=1), axis=1) > 1e-2 * scale[:, 0]
    dots = np.abs(np.einsum("nik,nik->nk", vec.numpy(), np.asarray(jvec)))
    assert np.all(dots[gap] > 1 - 1e-4)


def test_spectral_rebuild_matches_reference():
    cov = _spd_batch(np.random.default_rng(1))

    def clamp(lam):
        return lam.clamp(min=0.05) if isinstance(lam, torch.Tensor) else jnp.maximum(lam, 0.05)

    got = eig3.spectral_rebuild(T(cov), clamp).numpy()
    want = np.asarray(jeig3.spectral_rebuild(jnp.asarray(cov), clamp))
    scale = np.abs(cov).max(axis=(1, 2))[:, None, None] + 0.05
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-4)


@pytest.mark.parametrize("method", METHODS)
def test_regularize_covariance_matches_reference(method):
    cov = _spd_batch(np.random.default_rng(2))
    got = knn.regularize_covariance(T(cov), method).numpy()
    want = np.asarray(jknn.regularize_covariance(jnp.asarray(cov), method))
    if method == "frobenius":
        # two 3x3 LU inverses of matrices conditioned up to ~1e4 (the 1e-3
        # floor under zero eigenvalues): relative to the output's scale
        scale = np.abs(want).max(axis=(1, 2))[:, None, None]
        np.testing.assert_allclose(got / scale, want / scale, atol=1e-3)
        return
    if method == "plane":
        # PLANE keeps only the smallest eigenvector, which is arbitrary
        # within a repeated smallest eigenvalue: compare where it is unique
        lam = np.linalg.eigvalsh(cov.astype(np.float64))
        unique = lam[:, 1] - lam[:, 0] > 1e-2 * (np.abs(lam).max(axis=1) + 1e-6)
        got, want = got[unique], want[unique]
        assert unique.sum() > 400
    np.testing.assert_allclose(got, want, atol=2e-4)


@pytest.mark.parametrize("method", ["min_eig", "normalized_min_eig", "frobenius"])
def test_estimate_cov6_non_plane_regularizations(method):
    """The repaired fault: estimate_cov6 raised for these three methods."""
    rng = np.random.default_rng(3)
    pts = lidar_cloud(rng, 512, spread=0.8, lo=5.0, hi=30.0)
    mask = rng.random(512) < 0.9
    want = np.asarray(jknn.estimate_cov6(jnp.asarray(pts), jnp.asarray(mask), k=10, method=method,
                                         selector="exact"))
    got = knn.estimate_cov6(T(pts)[None], T(mask)[None], k=10, method=method,
                            selector="exact")[0].numpy()
    scale = np.abs(want).max(axis=0, keepdims=True)
    np.testing.assert_allclose(got / scale, want / scale, atol=1e-3)
