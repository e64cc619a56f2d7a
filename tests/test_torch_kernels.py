"""The algorithms of the redesigned kernels, on the CPU.

K2 (`csrc/knn_moments.cu`) selects the k-th smallest valid d2 and replays
the reference's bisection from it; `knn_moments_select_torch` is that
algorithm in plain torch, held here to the counting bisection (the count
plane bit for bit) and to the JAX kernel in interpret mode. K1's voxel
build sorts once and sums each run once; its result is held to the old
two-sort build and to the JAX build slot for slot. The argument checks
that guard the CUDA launches run here as plain calls."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import KNN_CASES, T, knn_batch, knn_instance

from rolo_tpu.ops.knn_moments import knn_moments as jknn_moments
from rolo_tpu.voxel import voxelmap as jvm

from rolo_tpu_torch.ops import knn_moments as km
from rolo_tpu_torch.ops import voxel_join as vj
from rolo_tpu_torch.voxel import voxelmap as vm
from rolo_tpu_torch.voxel.knn import moment_table

# both versions sum the same members' f32 planes (one bmm each): the
# counts agree bit for bit, the other planes to f32 round-off
REL = 1e-5


@pytest.mark.parametrize("k", [1, 20, 32])
@pytest.mark.parametrize("case,n", KNN_CASES)
def test_select_replay_matches_counting_bisection(case, n, k):
    xyz, mask, cand, cmask = knn_batch(case, n, k)
    xc = moment_table(cand, cmask).contiguous()
    want = km.knn_moments_torch(xyz, mask, cand, cmask, xc, k)
    got = km.knn_moments_select_torch(xyz, mask, cand, cmask, xc, k)
    assert torch.equal(got[:, 0], want[:, 0])
    scale = torch.clamp(want.abs().amax(dim=-1, keepdim=True), min=1.0)
    assert float(((got - want).abs() / scale).max()) <= REL
    assert not got[~mask[:, None, :].expand_as(got)].any()


def _moment_table16(xyz, mask):
    n = xyz.shape[0]
    xc = np.concatenate([np.ones((n, 1), np.float32), xyz, xyz[:, :1] * xyz,
                         xyz[:, 1:2] * xyz[:, 1:], xyz[:, 2:] * xyz[:, 2:]], 1) * mask[:, None]
    return np.pad(xc.T, ((0, 6), (0, 0))).astype(np.float32)


@pytest.mark.parametrize("case,k", [("lidar", 8), ("duplicates", 20), ("starved", 20)])
def test_select_replay_matches_reference_kernel(case, k):
    """Against the JAX Pallas kernel in interpret mode, as
    tests/test_torch_ops.py holds the counting version."""
    rng = np.random.default_rng(11)
    cand, cmask = knn_instance(rng, case, 320)
    c = np.where(cmask[:, None], cand, 0.0).astype(np.float32)
    xc = _moment_table16(c, cmask)
    want = np.asarray(jknn_moments(jnp.asarray(c), jnp.asarray(cmask), jnp.asarray(c),
                                   jnp.asarray(cmask), jnp.asarray(xc), k, interpret=True))
    got = km.knn_moments_select_torch(T(c)[None], T(cmask)[None], T(c)[None], T(cmask)[None],
                                      T(xc)[None], k)[0].numpy()
    # the reference sums a bf16 x3 split: membership agrees on all but rare
    # round-off ties, and the sums to that split's precision
    same = got[0] == want[0]
    assert same.mean() > 0.99
    np.testing.assert_allclose(got[:, same], want[:, same], rtol=2e-5, atol=2e-3)
    assert np.abs(got[:, ~cmask]).max(initial=0.0) == 0.0


def test_kernel_argument_checks():
    """What the CUDA wrappers refuse, checked without a launch: K2 takes
    1 <= k <= 32 (its register queue), a K1 join at most 58,112 table keys
    (one instance's keys in 227 KB of shared memory)."""
    for k in (1, 20, km.MAX_K):
        km.check_kernel_args(k)
    for k in (0, km.MAX_K + 1, 64):
        with pytest.raises(ValueError):
            km.check_kernel_args(k)
    vj.check_join_keys(8192)
    vj.check_join_keys(vj.MAX_SHARED_KEYS)
    with pytest.raises(ValueError):
        vj.check_join_keys(vj.MAX_SHARED_KEYS + 1)


def _grid_cloud(rng, n, res):
    """Points near uniform-voxel centres (away from every bin boundary, so
    both packages bin them alike), many voxels holding several points."""
    cells = rng.integers(-40, 40, (n // 3, 3))
    idx = rng.integers(0, len(cells), n)
    pts = (cells[idx] + 1.0) * res + rng.uniform(-0.2, 0.2, (n, 3)) * res
    mask = rng.random(n) < 0.85
    return np.where(mask[:, None], pts, 0.0).astype(np.float32), mask


def _old_two_sort_build(xyz, cov6, mask, capacity, resolution):
    """The previous build: sorted packs as the table, then a keyed sum of
    the unsorted packs against it (a second, stable sort on the card)."""
    pack = vj.pack_uniform(vm.uniform_coord(xyz, resolution))
    pack = torch.where(mask, pack, vj.INVALID_PACK).to(torch.int32)
    sp = torch.sort(pack, dim=-1).values
    n = xyz.shape[1]
    is_valid = sp != vj.INVALID_PACK
    new_seg = is_valid & torch.cat([torch.ones_like(sp[:, :1], dtype=torch.bool),
                                    sp[:, 1:] != sp[:, :-1]], dim=1)
    if capacity >= n:
        table = sp
    else:
        seg_id = torch.where(is_valid, torch.cumsum(new_seg.to(torch.int32), 1) - 1, 2**30)
        slot = torch.arange(capacity).expand(xyz.shape[0], capacity).contiguous()
        pos = torch.clamp(torch.searchsorted(seg_id.contiguous(), slot), 0, n - 1)
        table = torch.where(slot < new_seg.sum(1, keepdim=True), torch.gather(sp, 1, pos),
                            vj.INVALID_PACK).to(torch.int32)
    w = mask.float()
    data = torch.cat([w[:, None], xyz.transpose(1, 2) * w[:, None], cov6 * w[:, None]], 1)
    return table, vj.keyed_matmul_torch(data, pack, table)


@pytest.mark.parametrize("capacity", [4096, 384])
def test_single_sort_build_matches_two_sort_build_and_reference(capacity):
    rng = np.random.default_rng(21)
    res = 0.5
    pts, mask = _grid_cloud(rng, 1536, res)
    cov = (np.array([1.0, 0, 0, 1.0, 0, 1.0], np.float32)[:, None]
           * rng.uniform(0.5, 2.0, 1536).astype(np.float32))
    tm = vm.build_voxel_map(T(pts)[None], T(cov)[None], T(mask)[None], capacity, polar_res=None,
                            resolution=res)
    table, sums = _old_two_sort_build(T(pts)[None], T(cov)[None], T(mask)[None],
                                      min(capacity, 1536), res)
    np.testing.assert_array_equal(tm.pack.numpy(), table.numpy())
    valid = tm.valid[0].numpy()
    assert valid.sum() > 100 and (tm.num_points[0].numpy()[valid] > 1).sum() > 50  # runs > 1
    np.testing.assert_allclose(tm.num_points[0].numpy()[valid], sums[0, 0].numpy()[valid])
    denom = np.maximum(sums[0, 0].numpy(), 1.0)
    np.testing.assert_allclose(tm.mean[0].numpy()[:, valid], (sums[0, 1:4].numpy() / denom)[
        :, valid], rtol=1e-5, atol=1e-5)
    # the reference build, slot for slot
    jm = jvm.build_voxel_map(jnp.asarray(pts), jnp.asarray(cov), jnp.asarray(mask), capacity,
                             polar_res=None, resolution=res)
    np.testing.assert_array_equal(tm.pack[0].numpy(), np.asarray(jm.pack))
    np.testing.assert_array_equal(valid, np.asarray(jm.valid))
    np.testing.assert_allclose(tm.stats[0].numpy(), np.asarray(jm.stats), rtol=1e-5, atol=1e-5)
    # the stats are a [B, 10, V] view of a row-major table with 16-byte rows
    assert tm.stats.stride(1) == 1 and tm.stats.stride(2) % 4 == 0


def test_morton_order_is_a_stable_permutation_masked_last():
    """The spatial order the K2 wrapper hands the kernel: a permutation per
    instance, masked points last, neighbours in space close in the order."""
    rng = np.random.default_rng(31)
    xyz = torch.tensor(rng.uniform(-60, 60, (2, 4096, 3)).astype(np.float32))
    mask = torch.tensor(rng.random((2, 4096)) < 0.8)
    codes, order = km.morton_order(xyz, mask)
    assert torch.equal(torch.sort(order, dim=-1).values, torch.arange(4096).expand(2, -1))
    assert torch.all(codes[:, 1:] >= codes[:, :-1])
    n_valid = mask.sum(dim=1)
    for i in range(2):
        assert bool(mask[i, order[i, :n_valid[i]]].all())
        assert not bool(mask[i, order[i, n_valid[i]:]].any())
    again = km.morton_order(xyz, mask)[1]
    assert torch.equal(order, again)
    # consecutive sorted points lie closer than random pairs, by far
    p = xyz[0, order[0, :n_valid[0]]]
    step = (p[1:] - p[:-1]).norm(dim=-1).median()
    assert float(step) < 0.2 * float((p - p[torch.randperm(len(p))]).norm(dim=-1).median())
