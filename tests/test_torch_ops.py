"""Parity of the port's leaf math and plain kernel versions with the JAX
reference: so3/se3, sym3, solve_psd, voxel packs, keyed sum (K1) and k-NN
moments (K2)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import T, lidar_cloud

from rolo_tpu.geometry import se3 as jse3
from rolo_tpu.geometry import so3 as jso3
from rolo_tpu.ops import linalg as jlinalg
from rolo_tpu.ops import sym3 as jsym3
from rolo_tpu.ops import voxel_join as jvj
from rolo_tpu.ops.knn_moments import knn_moments as jknn_moments

from rolo_tpu_torch.geometry import se3, so3
from rolo_tpu_torch.ops import linalg, sym3
from rolo_tpu_torch.ops import voxel_join as vj
from rolo_tpu_torch.ops.knn_moments import knn_moments

F32 = dict(rtol=1e-5, atol=1e-6)  # one f32 op sequence, reordered sums at most


def _omegas(rng, n=64):
    w = rng.normal(size=(n, 3)).astype(np.float32)
    w[:8] *= 1e-6  # small-angle series branch
    w[8:16] *= 2.5  # large angles
    return w


def test_so3_exp_log_quat():
    w = _omegas(np.random.default_rng(0))
    r_j = np.asarray(jso3.exp(jnp.asarray(w)))
    r_t = so3.exp(T(w)).numpy()
    np.testing.assert_allclose(r_t, r_j, **F32)
    np.testing.assert_allclose(so3.log(T(r_j)).numpy(), np.asarray(jso3.log(jnp.asarray(r_j))),
                               rtol=1e-4, atol=2e-6)  # log near pi divides small numbers
    np.testing.assert_allclose(so3.matrix_to_quat(T(r_j)).numpy(),
                               np.asarray(jso3.matrix_to_quat(jnp.asarray(r_j))), **F32)
    rpy = np.random.default_rng(1).uniform(-3, 3, (32, 3)).astype(np.float32)
    np.testing.assert_allclose(
        so3.rpy_to_matrix(*T(rpy).unbind(-1)).numpy(),
        np.asarray(jso3.rpy_to_matrix(*jnp.asarray(rpy).T)), **F32)


def test_se3_exp_log_compose_inverse():
    rng = np.random.default_rng(2)
    xi = np.concatenate([_omegas(rng, 32), rng.normal(size=(32, 3)).astype(np.float32)], 1)
    tj = jse3.exp(jnp.asarray(xi))
    tt = se3.exp(T(xi))
    np.testing.assert_allclose(tt.rot.numpy(), np.asarray(tj.rot), **F32)
    np.testing.assert_allclose(tt.trans.numpy(), np.asarray(tj.trans), **F32)
    np.testing.assert_allclose(se3.log(tt).numpy(), np.asarray(jse3.log(tj)), rtol=1e-4, atol=1e-5)
    a_j, b_j = jse3.SE3(tj.rot[:16], tj.trans[:16]), jse3.SE3(tj.rot[16:], tj.trans[16:])
    a_t, b_t = se3.SE3(tt.rot[:16], tt.trans[:16]), se3.SE3(tt.rot[16:], tt.trans[16:])
    c_j, c_t = a_j.compose(b_j.inverse()), a_t.compose(b_t.inverse())
    np.testing.assert_allclose(c_t.rot.numpy(), np.asarray(c_j.rot), **F32)
    np.testing.assert_allclose(c_t.trans.numpy(), np.asarray(c_j.trans), rtol=1e-5, atol=1e-5)


def _spd6(rng, n):
    a = rng.normal(size=(n, 3, 3)).astype(np.float32)
    m = a @ np.swapaxes(a, -1, -2) + 0.1 * np.eye(3, dtype=np.float32)
    m[: n // 4] = np.diag([1e-4, 1.0, 1.0]).astype(np.float32)  # plane-like
    return np.asarray(jsym3.from_mat(jnp.asarray(m)))


def test_sym3_ops():
    rng = np.random.default_rng(3)
    s = _spd6(rng, 128)
    v = rng.normal(size=(3, 128)).astype(np.float32)
    r = np.asarray(jso3.exp(jnp.asarray([0.3, -0.2, 0.5])))
    cases = [
        (sym3.matvec(T(s), T(v)), jsym3.matvec(jnp.asarray(s), jnp.asarray(v))),
        (sym3.quad(T(s), T(v)), jsym3.quad(jnp.asarray(s), jnp.asarray(v))),
        (sym3.congruence(T(r), T(s)), jsym3.congruence(jnp.asarray(r), jnp.asarray(s))),
        (sym3.inv(T(s)), jsym3.inv(jnp.asarray(s))),
        (sym3.plane_regularize(T(s)), jsym3.plane_regularize(jnp.asarray(s))),
    ]
    for got, want in cases:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4, atol=1e-4)
    # batched congruence: one rotation per instance
    rb = np.stack([r, r.T])
    sb = np.stack([s, s[:, ::-1].copy()])
    got = sym3.congruence(T(rb), T(sb)).numpy()
    for i in range(2):
        np.testing.assert_allclose(got[i], np.asarray(jsym3.congruence(jnp.asarray(rb[i]),
                                                                       jnp.asarray(sb[i]))), **F32)


@pytest.mark.parametrize("n", [3, 6])
def test_solve_psd(n):
    rng = np.random.default_rng(4 + n)
    a = rng.normal(size=(64, n, n)).astype(np.float32)
    h = a @ np.swapaxes(a, -1, -2) + 1e-2 * np.eye(n, dtype=np.float32)
    b = rng.normal(size=(64, n)).astype(np.float32)
    got = linalg.solve_psd(T(h), T(b)).numpy()
    want = np.asarray(jlinalg.solve_psd(jnp.asarray(h), jnp.asarray(b)))
    # same unrolled op sequence; ill-conditioned draws amplify round-off
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)


def test_packs_match_reference():
    rng = np.random.default_rng(5)
    polar = np.stack([rng.integers(-5, 140, 3000), rng.integers(-3, 70, 3000),
                      rng.integers(-2, 1 << 19, 3000)], -1).astype(np.int32)
    uni = rng.integers(-600, 600, (3000, 3)).astype(np.int32)
    pp = vj.pack_polar(T(polar)).numpy()
    pu = vj.pack_uniform(T(uni)).numpy()
    np.testing.assert_array_equal(pp, np.asarray(jvj.pack_polar(jnp.asarray(polar))))
    np.testing.assert_array_equal(pu, np.asarray(jvj.pack_uniform(jnp.asarray(uni))))
    ok = pp != vj.INVALID_PACK
    np.testing.assert_array_equal(vj.unpack_polar(T(pp)).numpy()[ok], polar[ok])
    ok = pu != vj.INVALID_PACK
    np.testing.assert_array_equal(vj.unpack_uniform(T(pu)).numpy()[ok], uni[ok])


def _keyed_cases():
    rng = np.random.default_rng(6)
    inv = vj.INVALID_PACK
    # build: per-point keys (with sentinels carrying zero values) -> sorted table
    kk = rng.integers(0, 120, 700).astype(np.int32)
    kk[::9] = inv
    vals = rng.normal(size=(10, 700)).astype(np.float32) * 40.0
    vals[:, kk == inv] = 0.0
    build = (vals, kk, np.sort(kk))
    # join: sorted table with duplicate slots (zero stats off the run start)
    table = np.sort(rng.integers(0, 300, 512).astype(np.int32))
    table[-40:] = inv
    stats = rng.normal(size=(10, 512)).astype(np.float32)
    dup = np.concatenate([[False], table[1:] == table[:-1]]) | (table == inv)
    stats[:, dup] = 0.0
    queries = rng.integers(0, 320, 900).astype(np.int32)
    queries[::5] = inv
    join = (stats, table, queries)
    sentinel = (np.zeros((8, 128), np.float32), np.full(128, inv, np.int32),
                np.array([5, inv], np.int32))
    return {"build": build, "join_duplicate_slots": join, "sentinel": sentinel}


@pytest.mark.parametrize("case", ["build", "join_duplicate_slots", "sentinel"])
def test_keyed_matmul_matches_reference(case):
    vals, kk, km = _keyed_cases()[case]
    want = np.asarray(jvj.keyed_matmul(jnp.asarray(vals), jnp.asarray(kk), jnp.asarray(km)))
    got = vj.keyed_matmul(T(vals)[None], T(kk)[None], T(km)[None],
                          keys_sorted=case != "build")[0].numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)  # as tests/test_voxel_join.py
    assert vj.keyed_matmul.launches == 0  # CPU tensors never launch the kernel


def test_keyed_matmul_rejects_bad_operands():
    v = torch.zeros(1, 3, 4)
    k = torch.zeros(1, 4, dtype=torch.int32)
    with pytest.raises(TypeError):
        vj.keyed_matmul(v.double(), k, k)
    with pytest.raises(ValueError):
        vj.keyed_matmul(v, k[:, :3], k)
    with pytest.raises(ValueError):
        vj.keyed_matmul(torch.zeros(1, 17, 4), k, k)


def _moment_table16(xyz, mask):
    n = xyz.shape[0]
    xc = np.concatenate([np.ones((n, 1), np.float32), xyz, xyz[:, :1] * xyz,
                         xyz[:, 1:2] * xyz[:, 1:], xyz[:, 2:] * xyz[:, 2:]], 1) * mask[:, None]
    return np.pad(xc.T, ((0, 6), (0, 0))).astype(np.float32)


def _knn_case(name):
    rng = np.random.default_rng(7)
    if name == "lidar_scale":
        xyz = lidar_cloud(rng, 512)
        return xyz, np.ones(512, bool), xyz, np.ones(512, bool), 8
    if name == "nan_padding":
        xyz = lidar_cloud(rng, 384)
        mask = np.ones(384, bool)
        mask[300:] = False
        xyz[~mask] = np.nan
        return xyz, mask, xyz, mask, 6
    if name == "starved":
        xyz = lidar_cloud(rng, 256)
        mask = np.zeros(256, bool)
        mask[:8] = True
        return xyz, mask, xyz, mask, 20
    cand = lidar_cloud(rng, 640)  # query set != candidate set
    cmask = rng.random(640) < 0.9
    return cand[:128], cmask[:128].copy(), cand, cmask, 10


@pytest.mark.parametrize("case", ["lidar_scale", "nan_padding", "starved", "query_subset"])
def test_knn_moments_matches_reference_kernel(case):
    xyz, mask, cand, cmask, k = _knn_case(case)
    # the documented contract: callers zero masked coordinates first
    q = np.where(mask[:, None], xyz, 0.0).astype(np.float32)
    c = np.where(cmask[:, None], cand, 0.0).astype(np.float32)
    xc = _moment_table16(c, cmask)
    want = np.asarray(jknn_moments(jnp.asarray(q), jnp.asarray(mask), jnp.asarray(c),
                                   jnp.asarray(cmask), jnp.asarray(xc), k, interpret=True))
    got = knn_moments(T(q)[None], T(mask)[None], T(c)[None], T(cmask)[None], T(xc)[None], k)[0]
    got = got.numpy()
    assert knn_moments.launches == 0
    # Same bisection on the same f32 distances: membership agrees on all but
    # rare round-off ties, sums to f32 (the reference sums a bf16 x3 split).
    same = got[0] == want[0]
    assert same.mean() > 0.99
    np.testing.assert_allclose(got[:, same], want[:, same], rtol=2e-5, atol=2e-3)
    assert np.abs(got[:, ~mask]).max(initial=0.0) == 0.0

