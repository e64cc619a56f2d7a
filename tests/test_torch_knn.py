"""Parity of the port's `knn_indices` with the JAX reference
(rolo_tpu/voxel/knn.py:45-121): both distance forms, the k=1 argmin path,
masked queries and NaN-padded masked points, `approximate=True`, and an
explicit batch dim."""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import T, lidar_cloud

from rolo_tpu.voxel.knn import knn_indices as jknn_indices

from rolo_tpu_torch.voxel.knn import knn_indices

Q, N, CHUNK = 300, 1000, 128  # Q not a multiple of the chunk: the reference pads


def _inputs(seed):
    rng = np.random.default_rng(seed)
    pts = lidar_cloud(rng, N, spread=3.0, lo=10.0, hi=40.0)
    pmask = rng.random(N) < 0.85
    pts[~pmask] = np.nan  # padding garbage that must never enter a tile
    query = lidar_cloud(rng, Q, spread=3.0, lo=10.0, hi=40.0)
    qmask = rng.random(Q) < 0.8
    query[~qmask] = np.nan
    return query, qmask, pts, pmask


def _dist(query, pts, idx):
    return np.linalg.norm(pts[idx].astype(np.float64) - query[:, None, :], axis=-1)


@pytest.mark.parametrize("k", [1, 5, 16])
def test_elementwise_indices_match_reference(k):
    """The cancellation-free form orders neighbours f64-exactly in
    practice: the indices of valid queries agree one for one."""
    query, qmask, pts, pmask = _inputs(0)
    want = np.asarray(jknn_indices(jnp.asarray(query), jnp.asarray(qmask), jnp.asarray(pts),
                                   jnp.asarray(pmask), k, CHUNK, form="elementwise"))
    got = knn_indices(T(query), T(qmask), T(pts), T(pmask), k, CHUNK, form="elementwise").numpy()
    assert got.shape == (Q, k)
    np.testing.assert_array_equal(got[qmask], want[qmask])
    assert pmask[got[qmask]].all()  # masked (NaN) points are never neighbours


@pytest.mark.parametrize("k", [1, 5])
def test_matmul_form_distances_match_elementwise(k):
    """|q|^2 - 2 q.x + |x|^2 cancels at lidar range (~5e-3 m^2 of d2 noise,
    knn.py:69-77), so near-ties may swap: compare the sorted neighbour
    distances, not the indices, to 2e-3 m (the noise on a d2 of ~1 m^2)."""
    query, qmask, pts, pmask = _inputs(1)
    got = knn_indices(T(query), T(qmask), T(pts), T(pmask), k, CHUNK).numpy()
    ref = knn_indices(T(query), T(qmask), T(pts), T(pmask), k, CHUNK, form="elementwise").numpy()
    want = np.asarray(jknn_indices(jnp.asarray(query), jnp.asarray(qmask), jnp.asarray(pts),
                                   jnp.asarray(pmask), k, CHUNK))
    d_got = np.sort(_dist(query, pts, got)[qmask], axis=1)
    for other in (ref, want):
        np.testing.assert_allclose(d_got, np.sort(_dist(query, pts, other)[qmask], axis=1),
                                   atol=2e-3)
    assert pmask[got[qmask]].all()


def test_k1_is_argmin_of_the_tile():
    query, qmask, pts, pmask = _inputs(2)
    got = knn_indices(T(query), T(qmask), T(pts), T(pmask), 1, CHUNK, form="elementwise")
    top = knn_indices(T(query), T(qmask), T(pts), T(pmask), 2, CHUNK, form="elementwise")
    np.testing.assert_array_equal(got.numpy()[qmask, 0], top.numpy()[qmask, 0])


@pytest.mark.parametrize("form", ["matmul", "elementwise"])
def test_approximate_is_exact(form):
    query, qmask, pts, pmask = _inputs(3)
    args = (T(query), T(qmask), T(pts), T(pmask), 5, CHUNK)
    np.testing.assert_array_equal(knn_indices(*args, approximate=True, form=form).numpy(),
                                  knn_indices(*args, form=form).numpy())


def test_batch_dim_matches_per_instance():
    a, b = _inputs(4), _inputs(5)
    batched = knn_indices(*(T(np.stack([x, y])) for x, y in zip(a, b)), 5, CHUNK).numpy()
    for i, inp in enumerate((a, b)):
        single = knn_indices(*(T(x) for x in inp), 5, CHUNK).numpy()
        np.testing.assert_array_equal(batched[i][inp[1]], single[inp[1]])


def test_unknown_form_raises():
    query, qmask, pts, pmask = _inputs(6)
    with pytest.raises(ValueError):
        knn_indices(T(query), T(qmask), T(pts), T(pmask), 5, form="cosine")
