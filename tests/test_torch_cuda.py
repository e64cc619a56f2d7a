"""On-card checks of the port's CUDA kernels against their plain torch
versions, of the CUDA registration, mapping, loop-closure and prior paths
against the same calls on CPU tensors, of the same bits from two runs under
torch's default algorithms, and of the parallel slice on a one-rank group.

These need an NVIDIA GPU with nvcc; elsewhere they skip. They import no JAX,
so on the GPU machine (which has none) run them without the suite's
conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
"""

import functools

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import REL_TOL, plane_rel_err
from torch_parity import KNN_CASES, knn_batch, lidar_cloud

from rolo_tpu_torch import bench
from rolo_tpu_torch.config import RegistrationConfig, load_config
from rolo_tpu_torch.ops import cuda_build
from rolo_tpu_torch.ops.knn_moments import knn_moments, knn_moments_torch
from rolo_tpu_torch.ops.voxel_join import (INVALID_PACK, MAX_SHARED_KEYS, keyed_matmul,
                                           keyed_matmul_torch)
from rolo_tpu_torch.registration.rotgicp import register_scan_pair
from rolo_tpu_torch.runtime.platform import configure_precision
from rolo_tpu_torch.sim.dataset import SimFrame
from rolo_tpu_torch.voxel.knn import moment_table

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    configure_precision()
    return torch.device("cuda")


@pytest.mark.parametrize("name", ["keyed_sum", "knn_moments"])
def test_kernel_builds(cuda, name):
    path, _ = cuda_build.build(name)
    assert path.exists()
    print(cuda_build.BUILD_LOG.get(name, "(reused)"))


# params_os.yaml's shapes (24,576 feature slots, 16,384 voxels): the build's
# join of the sorted packs into the table, 24,576 keys in 96 KB of shared
# memory; the fine direct7 join, 7 x 24,576 = 172,032 queries
@pytest.mark.parametrize("b,s,k,m,sorted_keys", [
    (1, 3, 7, 5, True), (3, 10, 1000, 333, False), (16, 10, 8192, 57344, True),
    (2, 10, MAX_SHARED_KEYS - 112, 4096, True), (1, 10, 24576, 16384, True),
    (1, 10, 16384, 172032, True)])
def test_keyed_sum_matches_plain(cuda, b, s, k, m, sorted_keys):
    g = torch.Generator(device="cpu").manual_seed(0)
    keys_k = torch.randint(0, 300, (b, k), generator=g, dtype=torch.int32)
    keys_k[:, -k // 10:] = INVALID_PACK
    if sorted_keys:
        keys_k = torch.sort(keys_k, dim=-1).values
    keys_m = torch.randint(0, 320, (b, m), generator=g, dtype=torch.int32)
    keys_m[:, ::7] = INVALID_PACK
    values = torch.randn(b, s, k, generator=g) * 30.0
    values = torch.where((keys_k == INVALID_PACK)[:, None, :], 0.0, values)
    want = keyed_matmul_torch(values, keys_k, keys_m)
    before = keyed_matmul.launches
    got = keyed_matmul(values.to(cuda), keys_k.to(cuda), keys_m.to(cuda),
                       keys_sorted=sorted_keys)
    torch.cuda.synchronize()
    assert keyed_matmul.launches == before + 1
    assert plane_rel_err(got.cpu(), want) < REL_TOL


def _lidar(rng, b, n):
    return torch.as_tensor(np.stack([lidar_cloud(rng, n) for _ in range(b)]))


@pytest.mark.parametrize("b,q,n,k", [(2, 300, 300, 8), (16, 8192, 8192, 20),
                                     (1, 8192, 8192, 20), (16, 4096, 8192, 20),
                                     (1, 4096, 8192, 20), (1, 24576, 24576, 20),
                                     (4, 24576, 24576, 20)])
def test_knn_moments_matches_plain(cuda, b, q, n, k):
    """Q < N: the queries are the first Q candidates in a tensor of their
    own, as the point-split path's shard against the gathered cloud."""
    rng = np.random.default_rng(1)
    cand = _lidar(rng, b, n)
    cmask = torch.as_tensor(rng.random((b, n)) < 0.9)
    cand = torch.where(cmask[..., None], cand, 0.0)
    xyz, mask = cand[:, :q].contiguous(), cmask[:, :q].contiguous()
    xc = moment_table(cand, cmask).contiguous()
    dev = [t.to(cuda) for t in (xyz, mask, cand, cmask, xc)]
    want = knn_moments_torch(*dev, k)
    got = knn_moments(*dev, k)
    again = knn_moments(*dev, k)
    torch.cuda.synchronize()
    assert torch.equal(got[:, 0], want[:, 0])  # membership agrees bit for bit
    assert plane_rel_err(got, want) < REL_TOL
    assert torch.equal(got, again)  # no atomics: the same bits on every call


@functools.lru_cache(maxsize=1)
def _m2ud_cases():
    """chip_smoke phase 14 (a)'s cases: both kernels on a featurized pair
    of the M2UD sequence (scans 0 and 2 of a VLP-16 at 16 x 1,800, the
    driver's ring order) at configs/m2ud's capacities, B = 1: the K1 build
    [10, 8,192] and its polar and fine direct7 joins, K2 at Q = N = 8,192."""
    cfg = load_config(list(chip_smoke.M2UD_CONFIGS))
    dev = torch.device("cuda")
    frames = [SimFrame(stamp, *(torch.as_tensor(a, device=dev) for a in (
        xyz, ring.astype(np.int32), rel, gt_rot, gt_trans)))
        for stamp, xyz, ring, rel, gt_rot, gt_trans in chip_smoke.m2ud_scans(
            chip_smoke.m2ud_sim_config(cfg, 1 + chip_smoke.STRIDE), dev)]
    pair = bench.stack_pairs([bench.featurize(f, cfg) for f in frames], frames, 1,
                             chip_smoke.STRIDE)
    return [c for c in chip_smoke.kernel_cases(cfg, *pair[:4]) if "SPMD" not in c["case"]]


@pytest.mark.parametrize("name", ["keyed_sum", "knn_moments"])
def test_m2ud_kernel_cases_match_plain(cuda, name):
    counter = keyed_matmul if name == "keyed_sum" else knn_moments
    cases = [c for c in _m2ud_cases() if c["name"] == name]
    assert len(cases) == (3 if name == "keyed_sum" else 1)
    for c in cases:
        before = counter.launches
        got = c["kernel"]()
        want = c["plain"]()
        torch.cuda.synchronize()
        assert counter.launches == before + 1, c["case"]
        assert plane_rel_err(got, want) < REL_TOL, c["case"]
        if name == "knn_moments":
            assert torch.equal(got[:, 0], want[:, 0])
        assert torch.equal(got, c["kernel"]()), c["case"]


@pytest.mark.parametrize("k", [1, 20, 32])
@pytest.mark.parametrize("case,n", KNN_CASES)
def test_knn_moments_cases_match_plain(cuda, case, n, k):
    """tests/test_torch_kernels.py's cases on the card: ties, starved and
    all-masked instances, N < k, N off the 64-candidate tile."""
    xyz, mask, cand, cmask = knn_batch(case, n, k)
    xc = moment_table(cand, cmask).contiguous()
    dev = [t.to(cuda) for t in (xyz, mask, cand, cmask, xc)]
    want = knn_moments_torch(*dev, k)
    got = knn_moments(*dev, k)
    torch.cuda.synchronize()
    assert torch.equal(got[:, 0], want[:, 0])
    assert plane_rel_err(got, want) < REL_TOL
    assert torch.equal(got, knn_moments(*dev, k))


def test_knn_moments_spatial_order_kernels(cuda):
    """The wrapper's helper kernels: Morton codes as the plain version
    computes them, and the candidates gathered into sorted float4 tiles."""
    from rolo_tpu_torch.ops import knn_moments as km

    xyz, mask, cand, cmask = knn_batch("lidar", 300, 20)
    cand[0, :5] = torch.tensor([-300.0, 300.0, 0.07])  # clamped at the grid's edge
    codes, order = km.morton_order(cand.to(cuda), cmask.to(cuda))
    want_codes, want_order = km.morton_order(cand, cmask)
    assert torch.equal(codes.cpu(), want_codes) and torch.equal(order.cpu(), want_order)
    xc = moment_table(cand, cmask).contiguous()
    got = knn_moments(*(t.to(cuda) for t in (cand, cmask, cand, cmask, xc)), 20)
    want = knn_moments_torch(cand, cmask, cand, cmask, xc, 20)
    assert torch.equal(got[:, 0].cpu(), want[:, 0])


def test_knn_moments_refuses_k_above_queue(cuda):
    xyz, mask, cand, cmask = knn_batch("lidar", 300, 33)
    dev = [t.to(cuda) for t in (xyz, mask, cand, cmask, moment_table(cand, cmask))]
    before = knn_moments.launches
    with pytest.raises(ValueError):
        knn_moments(*dev, 33)
    assert knn_moments.launches == before


def test_knn_moments_starved_queries(cuda):
    cand = _lidar(np.random.default_rng(2), 1, 256)
    cmask = torch.zeros(1, 256, dtype=torch.bool)
    cmask[:, :8] = True
    cand = torch.where(cmask[..., None], cand, 0.0)
    xc = moment_table(cand, cmask)
    got = knn_moments(*(t.to(cuda) for t in (cand, cmask, cand, cmask, xc)), 20).cpu()
    assert torch.all(got[0, 0, :8] == 8.0)
    assert torch.all(got[0, :, 8:] == 0.0)


@pytest.mark.parametrize("run_heads", [False, True])
def test_keyed_sum_row_major_table(cuda, run_heads):
    """A join reading a row-major [B, K, 12] table through its [B, 10, K]
    view (float4 rows), as lookup_join reads build_voxel_map's stats; with
    run_heads, only each run's first slot holds values, as in a voxel table,
    and the join reads that slot alone."""
    g = torch.Generator(device="cpu").manual_seed(5)
    b, k, m = 4, 8192, 20000
    keys_k = torch.sort(torch.randint(0, 5000, (b, k), generator=g, dtype=torch.int32)).values
    keys_m = torch.randint(0, 5200, (b, m), generator=g, dtype=torch.int32)
    rows = torch.nn.functional.pad(torch.randn(b, k, 10, generator=g), (0, 2))
    if run_heads:
        dup = torch.cat([torch.zeros(b, 1, dtype=torch.bool), keys_k[:, 1:] == keys_k[:, :-1]], 1)
        rows[dup] = 0.0
    view = rows[..., :10].transpose(1, 2)
    want = keyed_matmul_torch(view, keys_k, keys_m)
    got = keyed_matmul(rows.to(cuda)[..., :10].transpose(1, 2), keys_k.to(cuda), keys_m.to(cuda),
                       keys_sorted=True, run_heads=run_heads)
    assert plane_rel_err(got.cpu(), want) < REL_TOL


def test_keyed_sum_run_sums_match_plain(cuda):
    """The build's self-join: each run summed once, written to all its
    slots; sentinel slots 0."""
    g = torch.Generator(device="cpu").manual_seed(6)
    b, k = 16, 8192
    keys = torch.randint(0, 1500, (b, k), generator=g, dtype=torch.int32)
    keys[:, -700:] = INVALID_PACK
    keys = torch.sort(keys).values
    values = torch.randn(b, 10, k, generator=g) * 30.0
    values = torch.where((keys == INVALID_PACK)[:, None], 0.0, values)
    want = keyed_matmul_torch(values, keys, keys)
    kd = keys.to(cuda)
    before = keyed_matmul.launches
    got = keyed_matmul(values.to(cuda), kd, kd, keys_sorted=True)
    torch.cuda.synchronize()
    assert keyed_matmul.launches == before + 1
    assert plane_rel_err(got.cpu(), want) < REL_TOL


def test_keyed_sum_refuses_table_above_shared_memory(cuda):
    keys = torch.zeros(1, MAX_SHARED_KEYS + 1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        keyed_matmul(torch.zeros(1, 2, keys.shape[1], device=cuda), keys, keys[:, :8].contiguous(),
                     keys_sorted=True)


@pytest.mark.parametrize("polar,capacity", [(True, 8192), (False, 8192), (False, 1024)])
def test_build_voxel_map_cuda_sorts_once(cuda, monkeypatch, polar, capacity):
    """The single-sort build on the card against the same build on CPU
    tensors, slot for slot, with one torch.sort per build."""
    from rolo_tpu_torch.voxel.voxelmap import build_voxel_map

    rng = np.random.default_rng(7)
    b, n = 4, 8192
    # points in the middle of their bins (0.2-0.8 of a bin from its lower
    # edge), so atan2 / acos ulps between the devices bin them alike
    cells = rng.integers(0, 400, (b, n // 4, 3)) + 0.2 + 0.6 * rng.random((b, n // 4, 3))
    cells = np.take_along_axis(cells, rng.integers(0, n // 4, (b, n, 1)), axis=1)
    if polar:  # (theta, phi, r) bins of (0.175, 0.175, 2.0), phi within 0.5-2.5 rad
        theta = (cells[..., 0] % 35) * 0.175 - np.pi
        phi = 0.525 + (cells[..., 1] % 11) * 0.175
        r = 2.0 + (cells[..., 2] % 20) * 2.0
        pts = np.stack([r * np.sin(phi) * np.cos(theta), r * np.sin(phi) * np.sin(theta),
                        r * np.cos(phi)], -1)
    else:  # uniform bins floor(a / 0.25 - 0.5)
        pts = ((cells % 160) - 80 + 0.5) * 0.25
    pts = torch.as_tensor(pts.astype(np.float32))
    mask = torch.as_tensor(rng.random((b, n)) < 0.75)
    pts = torch.where(mask[..., None], pts, 0.0)
    cov = torch.tensor([1.0, 0, 0, 1.0, 0, 1.0])[None, :, None] * torch.as_tensor(
        rng.uniform(0.5, 2.0, (b, 1, n)).astype(np.float32))
    kw = dict(polar_res=(0.175, 0.175, 2.0)) if polar else dict(polar_res=None, resolution=0.25)
    want = build_voxel_map(pts, cov, mask, capacity, **kw)
    sorts = []
    real_sort = torch.sort

    def counting_sort(*args, **kwargs):
        sorts.append(1)
        return real_sort(*args, **kwargs)

    monkeypatch.setattr(torch, "sort", counting_sort)
    got = build_voxel_map(pts.to(cuda), cov.to(cuda), mask.to(cuda), capacity, **kw)
    torch.cuda.synchronize()
    monkeypatch.setattr(torch, "sort", real_sort)
    assert len(sorts) == 1
    assert torch.equal(got.pack.cpu(), want.pack) and torch.equal(got.valid.cpu(), want.valid)
    assert plane_rel_err(got.stats.cpu(), want.stats) < REL_TOL


def test_registration_cuda_matches_cpu(cuda):
    rng = np.random.default_rng(3)
    n = 1024
    planes = []
    for axis, off in [(0, 8.0), (0, -9.0), (1, 10.0), (1, -7.0), (2, -1.5)]:
        p = rng.uniform(-8, 8, (n // 5, 3))
        p[:, axis] = off + rng.normal(0, 0.01, n // 5)
        planes.append(p)
    world = np.concatenate(planes).astype(np.float32)
    c, s = np.cos(0.04), np.sin(0.04)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    src = torch.tensor(np.stack([world, world]))
    moved = world @ rot.T
    tgt = torch.tensor(np.stack([moved + np.float32([0.2, 0.05, 0.0]), moved]))
    mask = torch.ones(2, world.shape[0], dtype=torch.bool)
    z = torch.zeros(2, 3)
    dt = torch.full((2,), 0.1)
    cfg = RegistrationConfig()
    want = register_scan_pair(src, mask, tgt, mask, z, z, dt, dt, cfg, 2048, 10)
    got = register_scan_pair(*(t.to(cuda) for t in (src, mask, tgt, mask, z, z, dt, dt)), cfg,
                             2048, 10)
    assert torch.allclose(got.rot.cpu(), want.rot, atol=1e-4)
    assert torch.allclose(got.trans.cpu(), want.trans, atol=1e-3)


def _mapping_run(frames, cfg, device):
    """scan_step on every scan and backend_step at the 0.15 s cadence, on
    `device`: (front-end poses, mapped outputs, kernel launches)."""
    from rolo_tpu_torch.bench import featurize_parts
    from rolo_tpu_torch.frontend.odometry import init_state, scan_step
    from rolo_tpu_torch.mapping.backend import backend_step, init_backend
    from rolo_tpu_torch.pointcloud.cloud import PaddedCloud, concat_clouds
    from rolo_tpu_torch.sim.dataset import SimFrame

    st, reg = cfg.static, cfg.registration
    front = init_state(st.max_feature_points, device)
    state = init_backend(cfg, device)
    keyed_matmul.launches = knn_moments.launches = 0
    fronts, outs, last = [], [], -float("inf")
    for i, f in enumerate(frames):
        fc, img = featurize_parts(SimFrame(*(t.to(device) if isinstance(t, torch.Tensor) else t
                                             for t in f)), cfg)
        feat = concat_clouds(fc.corners, fc.surfaces, st.max_feature_points)
        front, fo = scan_step(front, feat.xyz, feat.mask, 0.1, reg, st.max_voxels,
                              reg.k_correspondences)
        fronts.append((fo.pose_rot.cpu(), fo.pose_trans.cpu()))
        if i * 0.1 - last >= cfg.mapping.mapping_process_interval:
            last = i * 0.1
            raw = PaddedCloud(img.xyz.reshape(-1, 3), img.mask.reshape(-1))
            state, out = backend_step(state, fc.corners, fc.surfaces, raw, fo.pose_rot,
                                      fo.pose_trans, True, i * 0.1, cfg)
            outs.append((out.rot.cpu(), out.trans.cpu(), bool(out.keyframe_added)))
    return fronts, outs, (keyed_matmul.launches, knn_moments.launches)


def test_backend_step_cuda_matches_plain(cuda):
    """The mapping slice on the card (both kernels launched) against the
    same run on CPU tensors, where the kernel wrappers take their plain
    versions, from identical simulated scans at the fixture's capacities.
    Tolerances as tests/test_torch_backend.py states them between packages:
    the f32 plane fits and the sums round differently on the two devices."""
    from torch_parity import small_config, small_sim_kwargs

    from rolo_tpu_torch.sim.dataset import SimConfig, generate_sequence

    cfg = small_config(**{"mapping.mapping_process_interval": 0.15})
    frames = list(generate_sequence(SimConfig(**small_sim_kwargs(7)), "cpu"))
    want_front, want, plain_launches = _mapping_run(frames, cfg, "cpu")
    got_front, got, launches = _mapping_run(frames, cfg, cuda)
    assert plain_launches == (0, 0) and launches[0] > 0 and launches[1] > 0
    for (r, t), (wr, wt) in zip(got_front, want_front):
        assert float(torch.linalg.vector_norm(t - wt)) < 0.01
    assert len(got) == len(want) == 4
    for (r, t, added), (wr, wt, wadded) in zip(got, want):
        cos = float((torch.trace(r.T @ wr) - 1) / 2)
        assert np.degrees(np.arccos(min(1.0, cos))) < 0.3
        assert float(torch.linalg.vector_norm(t - wt)) < 0.02
        assert added == wadded


# The third slice on the card: loop closure, the ground priors and the
# contact solver against the same calls on CPU tensors. Between the two
# devices the 1-NN matmuls, the plane fits and the graph sums round in other
# orders, so the ICP tolerances of tests/test_torch_loop.py apply.
ICP_ROT_RAD, ICP_TRANS_M, FITNESS_REL = 1e-3, 1e-3, 1e-3


def _rot_diff_rad(r1, r2):
    from torch_parity import rot_diff_rad

    return float(np.max(rot_diff_rad(r1.cpu().numpy(), r2.cpu().numpy())))


def test_icp_cuda_matches_cpu(cuda):
    from torch_parity import structured_world

    from rolo_tpu_torch.geometry import so3
    from rolo_tpu_torch.loop.closure import icp_point2point
    from rolo_tpu_torch.pointcloud.cloud import PaddedCloud

    _, surf = structured_world()
    rng = np.random.default_rng(4)
    src = torch.tensor(surf + 20.0)  # world-scale coordinates
    rot = so3.exp(torch.tensor([0.0, 0.01, 0.08]))
    tgt = src @ rot.T + torch.tensor([0.3, -0.2, 0.05]) + torch.tensor(
        rng.normal(0, 0.02, surf.shape), dtype=torch.float32)
    mask = torch.ones(len(surf), dtype=torch.bool)
    args = dict(max_corr_dist=5.0, max_iterations=100)
    want = icp_point2point(PaddedCloud(src, mask), PaddedCloud(tgt, mask), torch.eye(3),
                           torch.zeros(3), **args)
    got = icp_point2point(PaddedCloud(src.to(cuda), mask.to(cuda)),
                          PaddedCloud(tgt.to(cuda), mask.to(cuda)), torch.eye(3, device=cuda),
                          torch.zeros(3, device=cuda), **args)
    assert bool(got.converged) == bool(want.converged)
    assert _rot_diff_rad(got.rot, want.rot) < ICP_ROT_RAD
    assert float((got.trans.cpu() - want.trans).norm()) < ICP_TRANS_M
    assert abs(float(got.fitness) - float(want.fitness)) <= FITNESS_REL * float(want.fitness)


def _loops(state):
    g = state.graph.loops
    return [(int(g.i[k]), int(g.j[k])) for k in range(int(g.count))]


def _same_loops(got, want):
    assert _loops(got) == _loops(want)
    n = int(want.graph.loops.count)
    g, w = got.graph.loops, want.graph.loops
    assert torch.equal(got.loop_matched.cpu(), want.loop_matched)
    assert float((g.rel_trans[:n].cpu() - w.rel_trans[:n]).abs().max()) < ICP_TRANS_M
    for k in range(n):
        assert _rot_diff_rad(g.rel_rot[k], w.rel_rot[k]) < ICP_ROT_RAD
    assert torch.allclose(g.noise_var[:n].cpu(), w.noise_var[:n], rtol=FITNESS_REL)


@pytest.mark.parametrize("kind", ["all", "rs"])
def test_loop_closure_step_cuda_matches_cpu(cuda, kind):
    """The out-and-back return closes the same loop (13, 0) on both devices."""
    from torch_parity import loop_test_config, port_out_and_back

    from rolo_tpu_torch.mapping.backend import loop_closure_step

    cfg = loop_test_config(kind)
    want, wclosed = loop_closure_step(port_out_and_back(cfg, "cpu"), cfg)
    got, closed = loop_closure_step(port_out_and_back(cfg, cuda), cfg)
    assert bool(closed) == bool(wclosed) and _loops(got) == [(13, 0)]
    _same_loops(got, want)


def test_external_loop_step_cuda_matches_cpu(cuda):
    from torch_parity import loop_test_config, port_out_and_back

    from rolo_tpu_torch.mapping.backend import external_loop_step

    cfg = loop_test_config("rs")
    want, wclosed = external_loop_step(port_out_and_back(cfg, "cpu"), 13.0, 0.0, cfg)
    got, closed = external_loop_step(port_out_and_back(cfg, cuda), 13.0, 0.0, cfg)
    assert bool(closed) and bool(wclosed)
    _same_loops(got, want)


@pytest.mark.parametrize("x,y,yaw", [(11.0, -6.5, 0.7), (-15.0, 9.0, -2.4)])
def test_solve_pose_cuda_matches_cpu(cuda, x, y, yaw):
    """The contact solver on the simulator's terrain (z / roll / pitch to
    1e-4, as tests/test_torch_prior.py holds it against the reference)."""
    from rolo_tpu_torch.config import PriorConfig
    from rolo_tpu_torch.prior.ground import GroundMap
    from rolo_tpu_torch.prior.vehicle import from_config, solve_pose
    from rolo_tpu_torch.sim.dataset import SimConfig, ground_map_points

    cfg = PriorConfig(tolerance_roll=0.5, tolerance_pitch=0.5)
    pts = ground_map_points(SimConfig(period=20.0, roughness=1.2), "cpu")
    mask = torch.ones(len(pts), dtype=torch.bool)
    want = solve_pose(GroundMap(pts, mask), from_config(cfg, "cpu"), x, y, yaw, cfg)
    got = solve_pose(GroundMap(pts.to(cuda), mask.to(cuda)), from_config(cfg, cuda), x, y, yaw,
                     cfg)
    assert bool(got.success) == bool(want.success) and bool(got.converged)
    for field in ("z", "roll", "pitch"):
        assert abs(float(getattr(got, field)) - float(getattr(want, field))) < 1e-4, field


def _prior_scenario(device):
    """tests/test_torch_lap.py's scenario without JAX: the out-and-back
    state with a prior at (1, 0) linked to keyframe 1, a plane ground at the
    structured world's z = -1.5, and a fusion state fed the keyframes."""
    from torch_parity import loop_test_config, port_out_and_back

    from rolo_tpu_torch.filter.fusion import init_fusion, on_front_odometry, on_mapping_odometry
    from rolo_tpu_torch.prior.association import compute_prior, push_prior
    from rolo_tpu_torch.prior.ground import GroundMap
    from rolo_tpu_torch.prior.vehicle import from_config

    cfg = loop_test_config("all")
    cfg = cfg.replace(prior=type(cfg.prior)(near_prior_radius=2.0, fitness_score=0.05,
                                            tolerance_roll=0.5, tolerance_pitch=0.5))
    rng = np.random.default_rng(0)
    pts = np.column_stack([rng.uniform(-12, 12, (8192, 2)),
                           -1.5 + rng.normal(0, 0.005, 8192)]).astype(np.float32)
    gm = GroundMap(torch.tensor(pts, device=device),
                   torch.ones(8192, dtype=torch.bool, device=device))
    state = port_out_and_back(cfg, device)
    vehicle = from_config(cfg.prior, device)
    obs = compute_prior(gm, vehicle, 1.0, 0.0, float(np.pi), cfg.prior,
                        state.prior_queue.patch_xyz.shape[1])
    db = state.db
    state = state._replace(prior_queue=push_prior(state.prior_queue, obs, 1, db.rot[1],
                                                  db.trans[1]))
    fus = init_fusion(cfg.filter, device)
    for i in range(int(db.count)):
        fus, _ = on_front_odometry(fus, float(i), db.rot[i], db.trans[i], cfg.filter)
    fus = on_mapping_odometry(fus, db.rot[13], db.trans[13], db.rot[13], db.trans[13])
    return cfg, state, fus, gm, vehicle


def test_prior_cycle_cuda_matches_cpu(cuda):
    """One prior cycle, then a graph solve: the same prior factor (1, 13)
    and the same queue on both devices, the solved poses within the ICP
    tolerance."""
    from rolo_tpu_torch.mapping.backend import solve_graph_host
    from rolo_tpu_torch.runtime.cycles import prior_cycle

    results = []
    for device in ("cpu", cuda):
        cfg, state, fus, gm, vehicle = _prior_scenario(device)
        state, matched = prior_cycle(fus, 13.0, state, gm, vehicle, cfg)
        results.append((bool(matched), state, solve_graph_host(state, cfg)))
    (wm, want, wsolved), (m, got, solved) = results
    assert m and wm
    g, w = got.graph.priors, want.graph.priors
    assert (int(g.count), int(g.i[0]), int(g.j[0])) == (int(w.count), 1, 13)
    assert int(got.prior_queue.count) == int(want.prior_queue.count) == 2
    assert float((g.rel_trans[0].cpu() - w.rel_trans[0]).abs().max()) < ICP_TRANS_M
    assert torch.allclose(g.noise_var[0].cpu(), w.noise_var[0], rtol=FITNESS_REL)
    n = int(solved.db.count)
    assert float((solved.db.trans[:n].cpu() - wsolved.db.trans[:n]).abs().max()) < ICP_TRANS_M


# The sixth slice on the card: sums in a fixed order (the same bits on every
# run under torch's default algorithms), batches that give each instance its
# own bits, SE(3) registration and the point-split path.


def test_voxel_downsample_rings_is_deterministic(cuda):
    from rolo_tpu_torch.pointcloud.features import voxel_downsample_rings

    rng = np.random.default_rng(11)
    xyz = torch.tensor(lidar_cloud(rng, 64 * 1024, spread=30.0, lo=-80.0, hi=80.0)).reshape(
        64, 1024, 3).to(cuda)
    sel = torch.tensor(rng.random((64, 1024)) < 0.8).to(cuda)
    first = voxel_downsample_rings(xyz.clone(), sel.clone(), 0.4, 8192)
    second = voxel_downsample_rings(xyz.clone(), sel.clone(), 0.4, 8192)
    assert torch.equal(first.xyz, second.xyz) and torch.equal(first.mask, second.mask)
    want = voxel_downsample_rings(xyz.cpu(), sel.cpu(), 0.4, 8192)
    assert torch.equal(first.mask.cpu(), want.mask)
    assert float((first.xyz.cpu() - want.xyz).abs().max()) < 1e-4


def _looped_state(device):
    """The out-and-back state with its loop (13, 0) closed."""
    from torch_parity import loop_test_config, port_out_and_back

    from rolo_tpu_torch.mapping.backend import loop_closure_step

    cfg = loop_test_config("all")
    state, closed = loop_closure_step(port_out_and_back(cfg, device), cfg)
    assert bool(closed)
    return state


@pytest.mark.parametrize("method", ["bcr", "dense", "pcg"])
def test_solve_pose_graph_is_deterministic(cuda, method):
    from rolo_tpu_torch.graph.solver import solve_pose_graph
    from rolo_tpu_torch.mapping.backend import backend_state_from_numpy, backend_state_to_numpy

    arrays = backend_state_to_numpy(_looped_state(cuda))
    sols = []
    for _ in range(2):
        st = backend_state_from_numpy(arrays, cuda)
        sols.append(solve_pose_graph(st.graph, st.db.rot, st.db.trans, st.db.count,
                                     method=method))
    assert all(torch.equal(a, b) for a, b in zip(*sols))
    assert int(sols[0].iterations) >= 1


def test_backend_step_is_deterministic(cuda):
    """One mapping step twice from copies of one state: the same bits."""
    from torch_parity import small_config, small_sim_kwargs

    from rolo_tpu_torch.bench import featurize_parts
    from rolo_tpu_torch.mapping.backend import (backend_state_from_numpy, backend_state_to_numpy,
                                                backend_step, init_backend)
    from rolo_tpu_torch.pointcloud.cloud import PaddedCloud
    from rolo_tpu_torch.sim.dataset import SimConfig, generate_sequence

    cfg = small_config()
    frames = list(generate_sequence(SimConfig(**small_sim_kwargs(4)), cuda))
    state = init_backend(cfg, cuda)
    parts = [featurize_parts(f, cfg) for f in frames]
    eye = torch.eye(3, device=cuda)
    for i, (fc, img) in enumerate(parts[:3]):
        raw = PaddedCloud(img.xyz.reshape(-1, 3), img.mask.reshape(-1))
        state, _ = backend_step(state, fc.corners, fc.surfaces, raw, eye, frames[i].gt_trans,
                                True, 0.5 * i, cfg)
    arrays = backend_state_to_numpy(state)
    fc, img = parts[3]
    raw = PaddedCloud(img.xyz.reshape(-1, 3), img.mask.reshape(-1))
    runs = [backend_step(backend_state_from_numpy(arrays, cuda), fc.corners, fc.surfaces, raw,
                         eye, frames[3].gt_trans, True, 1.5, cfg) for _ in range(2)]
    (st_a, out_a), (st_b, out_b) = runs
    assert all(torch.equal(a, b) for a, b in zip(out_a, out_b))
    flat_a, flat_b = backend_state_to_numpy(st_a), backend_state_to_numpy(st_b)
    assert all(np.array_equal(flat_a[key], flat_b[key]) for key in flat_a)


def _se3_scene():
    rng = np.random.default_rng(5)
    planes = []
    for axis, off in [(0, 8.0), (0, -9.0), (1, 10.0), (1, -7.0), (2, -1.5)]:
        p = rng.uniform(-8, 8, (400, 3))
        p[:, axis] = off + rng.normal(0, 0.01, 400)
        planes.append(p)
    world = np.concatenate(planes).astype(np.float32)
    c, s = np.cos(0.03), np.sin(0.03)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    moved = world @ rot.T + np.float32([0.2, -0.1, 0.05])
    return torch.tensor(world)[None], torch.tensor(moved)[None], torch.ones(1, len(world),
                                                                          dtype=torch.bool)


def test_register_se3_cuda_matches_cpu(cuda):
    from rolo_tpu_torch.registration.rotgicp import register_se3

    src, tgt, mask = _se3_scene()
    args = (torch.eye(3)[None], torch.zeros(1, 3))
    cfg = RegistrationConfig(voxel_type="uniform", voxel_resolution=1.0)
    want = register_se3(src, mask, tgt, mask, *args, cfg, 4096, 20)
    got = register_se3(*(t.to(cuda) for t in (src, mask, tgt, mask, *args)), cfg, 4096, 20)
    assert torch.allclose(got.rot.cpu(), want.rot, atol=1e-4)
    assert torch.allclose(got.trans.cpu(), want.trans, atol=1e-3)


def test_batches_give_each_instance_its_bits_on_card(cuda):
    """register_scan_pair at B=2 and the contact solver at B=8 against the
    same instances alone, on the card."""
    from rolo_tpu_torch.config import PriorConfig
    from rolo_tpu_torch.prior.ground import GroundMap
    from rolo_tpu_torch.prior.vehicle import from_config, solve_pose
    from rolo_tpu_torch.sim.dataset import SimConfig, ground_map_points

    src, tgt, mask = _se3_scene()
    src2, tgt2 = torch.cat([src, tgt]).to(cuda), torch.cat([tgt, src]).to(cuda)
    mask2 = torch.cat([mask, mask]).to(cuda)
    z, dt = torch.zeros(2, 3, device=cuda), torch.full((2,), 0.1, device=cuda)
    cfg = RegistrationConfig()
    both = register_scan_pair(src2, mask2, tgt2, mask2, z, z, dt, dt, cfg, 4096, 20)
    for i in range(2):
        one = register_scan_pair(src2[i:i + 1], mask2[i:i + 1], tgt2[i:i + 1], mask2[i:i + 1],
                                 z[:1], z[:1], dt[:1], dt[:1], cfg, 4096, 20)
        assert all(torch.equal(a[0], b[i]) for a, b in zip(one, both))

    pcfg = PriorConfig(tolerance_roll=0.5, tolerance_pitch=0.5)
    pts = ground_map_points(SimConfig(period=20.0, roughness=1.2), cuda)
    gm = GroundMap(pts, torch.ones(len(pts), dtype=torch.bool, device=cuda))
    vm = from_config(pcfg, cuda)
    xs = torch.linspace(-15.0, 15.0, 8, device=cuda)
    ys, yaws = torch.linspace(-9.0, 9.0, 8, device=cuda), torch.linspace(-2.4, 2.4, 8, device=cuda)
    batch = solve_pose(gm, vm, xs, ys, yaws, pcfg)
    for i in range(8):
        one = solve_pose(gm, vm, xs[i], ys[i], yaws[i], pcfg)
        assert all(torch.equal(a, b[i]) for a, b in zip(one, batch))


def _ct_problem(device, bsz, fine):
    """lm_translation_rebind's arguments as the front-end passes them, on
    _se3_scene's pair with each instance's target shifted apart: the polar
    direct1 context, or the uniform direct7 one of the fine stage; the
    interval a stride-0 view, as scan_step expands it."""
    from rolo_tpu_torch.registration import gicp
    from rolo_tpu_torch.voxel.knn import estimate_cov6
    from rolo_tpu_torch.voxel.voxelmap import build_voxel_map

    cfg = load_config()
    reg = cfg.registration
    src, tgt, mask = (t.to(device) for t in _se3_scene())
    shift = 0.02 * torch.arange(bsz, dtype=torch.float32, device=device)
    src = src.expand(bsz, -1, -1).contiguous()
    tgt = tgt + torch.stack([shift, -0.5 * shift, 0.2 * shift], dim=-1)[:, None]
    mask = mask.expand(bsz, -1).contiguous()
    cov = [estimate_cov6(x, mask, k=20, method=reg.regularization) for x in (src, tgt)]
    polar = None if fine else tuple(reg.polar_resolution)
    res = reg.ct_fine_resolution if fine else reg.voxel_resolution
    vmap = build_voxel_map(tgt, cov[1], mask, 4096, polar_res=polar, resolution=res)
    ctx = gicp.make_context(src, mask, cov[0], vmap, polar_res=polar, resolution=res,
                            neighbor_search=reg.ct_fine_neighbors if fine else "direct1")
    eye = torch.eye(3, device=device).expand(bsz, 3, 3)
    z = torch.zeros(bsz, 3, device=device)
    dt = torch.as_tensor(0.1, device=device).expand(bsz)
    return (ctx, eye, z, z, z, dt, dt, reg.ct_lambda), dict(
        rebind_rounds=2, max_outer=16, max_inner=reg.lm_max_inner_iterations,
        trans_eps=reg.transformation_epsilon, init_lambda_factor=reg.lm_init_lambda_factor)


@pytest.mark.parametrize("fine", [False, True])
@pytest.mark.parametrize("bsz", [1, 16])
def test_graphed_ct_lm_is_bit_equal_to_eager(cuda, monkeypatch, bsz, fine):
    """The CT LM's replayed iterations against the eager loop, every field
    bit-equal: a first call (which may capture), a second on the same key
    from another start, so with other correspondences (stale buffers would
    show), and the first call's result after the second (aliasing would)."""
    from rolo_tpu_torch.registration import lm
    from rolo_tpu_torch.runtime import replay

    args, kw = _ct_problem(cuda, bsz, fine)
    starts = (args[2], args[2] + torch.tensor([0.05, -0.03, 0.01], device=cuda))
    graphed = [lm.lm_translation_rebind(*args[:2], t0, *args[3:], **kw) for t0 in starts]
    first = [x.clone() for x in graphed[0]]
    again = lm.lm_translation_rebind(*args, **kw)
    monkeypatch.setattr(replay, "replayed", replay.eager)  # the card path, run eagerly
    eager = [lm.lm_translation_rebind(*args[:2], t0, *args[3:], **kw) for t0 in starts]
    assert int(eager[0].iterations.min()) > 0
    assert not torch.equal(eager[0].trans, eager[1].trans)
    for got, want in zip(graphed + [again], eager + [eager[0]]):
        for name, g, w in zip(lm.CTResult._fields, got, want):
            assert torch.equal(g, w), name
    assert all(torch.equal(a, b) for a, b in zip(graphed[0], first))


def test_ct_lm_counts_its_path_on_card(cuda, monkeypatch):
    """On the card the CT LM replays its iterations without hooks and runs
    them eagerly under hooks (the point-sharded path's collectives are not
    captured); traced, both give the untraced bits and the same LM counts."""
    from rolo_tpu_torch.registration import gicp, lm
    from rolo_tpu_torch.runtime import profiling

    args, kw = _ct_problem(cuda, 2, False)
    plain = lm.lm_translation_rebind(*args, **kw)
    hooks = dict(ct_linearize_fn=lambda *a: gicp.ct_linearize(*a),
                 ct_error_fn=lambda *a: gicp.ct_error(*a))
    timers = profiling.StageTimers()
    timers.tracing = True
    with timers.stage("graphed"):
        graphed = lm.lm_translation_rebind(*args, **kw)
    with timers.stage("hooked"):
        hooked = lm.lm_translation_rebind(*args, **kw, **hooks)
    for got in (graphed, hooked):
        assert all(torch.equal(a, b) for a, b in zip(got, plain))
    s = timers.summary()
    assert s["graphed.ct_graph_iterations"]["total"] > 0
    assert s["hooked.ct_eager_iterations"]["total"] == s["graphed.ct_graph_iterations"]["total"]
    assert "graphed.ct_eager_iterations" not in s and "hooked.ct_graph_iterations" not in s
    for name in ("lm_iterations", "lm_trials", "lm_trials_used"):
        assert s[f"graphed.{name}"]["total"] == s[f"hooked.{name}"]["total"], name


def _contact_setup(device, case):
    """A contact solve's arguments as the prior cycle passes them: the
    pinned vehicle and gates, the simulator's terrain in a live map's 32,768
    slots (the rest masked out), the queries. "converging": the small robot
    (M2UD) on smooth ground; "capped": the truck (vlp32) where rough ground
    keeps the LM at `max_iters`; "empty": an empty map; "batch": four of
    the truck's queries at once."""
    from rolo_tpu_torch.prior.ground import GroundMap
    from rolo_tpu_torch.sim.dataset import SimConfig, ground_map_points

    paths = ["configs/params.yaml", "configs/prior_pose_params.yaml"]
    if case == "converging":
        paths += ["configs/m2ud/params.yaml", "configs/m2ud/prior_pose_params.yaml"]
    cfg = load_config(paths).prior
    pts = ground_map_points(SimConfig(period=20.0, roughness=0.0 if case == "converging"
                                      else 5.0), "cpu")
    xyz = torch.zeros(64 * 512, 3)
    xyz[:len(pts)] = pts
    mask = torch.arange(64 * 512) < (0 if case == "empty" else len(pts))
    query = {"converging": (5.0, 3.0, 1.0), "capped": (-0.3, -3.51, 2.01),
             "empty": (1.0, 2.0, 0.3),
             "batch": ([-0.3, 4.02, 11.0, -9.93], [-3.51, -2.28, -6.5, 7.74],
                       [2.01, 0.41, 0.7, 1.21])}[case]
    query = tuple(torch.tensor(q, device=device) for q in query)
    return GroundMap(xyz.to(device), mask.to(device)), cfg, query


def _contact_graphs(graphs):
    """The contact LM's captured iterations in a `replay._GRAPHS`."""
    from rolo_tpu_torch.prior import vehicle

    return [g for k, g in graphs.items() if k[0] is vehicle._contact_iteration]


def _traced_solve(gm, cfg, query):
    """solve_pose inside a traced `prior` stage: (result, its counters)."""
    from rolo_tpu_torch.prior.vehicle import from_config, solve_pose
    from rolo_tpu_torch.runtime import profiling

    timers = profiling.StageTimers()
    timers.tracing = True
    with timers.stage("prior"):
        res = solve_pose(gm, from_config(cfg, gm.xyz.device), *query, cfg)
    return res, {k[len("prior."):]: v["total"] for k, v in timers.summary().items()
                 if k.startswith("prior.contact_")}


@pytest.mark.parametrize("case", ["converging", "capped", "empty", "batch"])
def test_graphed_contact_lm_is_bit_equal_to_eager(cuda, monkeypatch, case):
    """The contact LM's replayed iterations against the eager loop on the
    card: every SolverResult field bit-equal, the same iteration count; a
    batch of four gives each query its bits alone."""
    from rolo_tpu_torch.prior import vehicle
    from rolo_tpu_torch.runtime import replay

    monkeypatch.setattr(replay, "_GRAPHS", {})
    gm, cfg, query = _contact_setup(cuda, case)
    graphed, counts = _traced_solve(gm, cfg, query)
    assert len(_contact_graphs(replay._GRAPHS)) == 1
    monkeypatch.setattr(replay, "replayed", replay.eager)  # run eagerly
    eager, eager_counts = _traced_solve(gm, cfg, query)
    n = counts["contact_iterations"]
    assert counts == eager_counts == {"contact_iterations": n, "contact_graph_iterations": n}
    for name, g, w in zip(vehicle.SolverResult._fields, graphed, eager):
        assert torch.equal(g, w), name
    if case == "converging":
        assert bool(eager.converged) and bool(eager.success) and 0 < n < cfg.max_iters
    elif case == "capped":
        assert not bool(eager.converged) and n == cfg.max_iters
    elif case == "empty":
        assert not bool(eager.success) and n > 0
    else:
        monkeypatch.undo()
        for i in range(4):
            one, _ = _traced_solve(gm, cfg, tuple(q[i] for q in query))
            assert all(torch.equal(a, b[i]) for a, b in zip(one, graphed)), i


def test_contact_graph_serves_a_second_map_without_a_capture(cuda, monkeypatch):
    """A second solve on another ground map and query of the same key
    replays the first call's graph, with no second capture, and gives the
    eager loop's bits; the first call's result is not overwritten."""
    from rolo_tpu_torch.prior import vehicle
    from rolo_tpu_torch.runtime import replay

    graphs = {}
    monkeypatch.setattr(replay, "_GRAPHS", graphs)
    gm, cfg, query = _contact_setup(cuda, "capped")
    first, _ = _traced_solve(gm, cfg, query)
    kept = [x.clone() for x in first]
    (graph,) = _contact_graphs(graphs)
    gm2 = gm._replace(xyz=gm.xyz + torch.tensor([0.5, -0.25, 0.1], device=cuda))
    query2 = (query[0] + 3.0, query[1] - 1.0, query[2] - 0.5)
    second, counts = _traced_solve(gm2, cfg, query2)
    assert _contact_graphs(graphs) == [graph]
    assert all(torch.equal(a, b) for a, b in zip(first, kept))
    monkeypatch.setattr(replay, "replayed", replay.eager)
    eager, eager_counts = _traced_solve(gm2, cfg, query2)
    assert counts == eager_counts
    assert not torch.equal(second.z, first.z)
    for name, g, w in zip(vehicle.SolverResult._fields, second, eager):
        assert torch.equal(g, w), name


def test_spmd_one_rank_cuda_matches_cpu(cuda):
    """register_scan_pair_spmd on a one-rank NCCL group against the same on
    a gloo group over CPU tensors (2e-4 / 2e-3, tests/test_parallel.py's
    tolerances), and against register_scan_pair on the card."""
    import torch.distributed as dist

    from rolo_tpu_torch.parallel.mesh import make_mesh
    from rolo_tpu_torch.parallel.spmd import register_scan_pair_spmd

    src, tgt, mask = (t[0] for t in _se3_scene())
    z, dt = torch.zeros(3), torch.tensor(0.1)
    cfg = RegistrationConfig()
    mesh = make_mesh(axis_names=("point",), device_type="cuda")
    try:
        got = register_scan_pair_spmd(mesh, *(t.to(cuda) for t in (src, mask, tgt, mask, z, z,
                                                                   dt, dt)), cfg, 4096, 20)
        want = register_scan_pair_spmd(dist.new_group(backend="gloo"), src, mask, tgt, mask, z, z,
                                       dt, dt, cfg, 4096, 20)
        one = register_scan_pair(*(t[None].to(cuda) for t in (src, mask, tgt, mask, z, z, dt, dt)),
                                 cfg, 4096, 20)
    finally:
        dist.destroy_process_group()
    assert torch.allclose(got.rot.cpu(), want.rot, atol=2e-4)
    assert torch.allclose(got.trans.cpu(), want.trans, atol=2e-3)
    assert torch.allclose(got.rot, one.rot[0], atol=2e-4)
    assert torch.allclose(got.trans, one.trans[0], atol=2e-3)


def test_estimate_covariances_cuda_matches_plain(cuda):
    """The reference-shaped covariances through K2 on the card against the
    same call on CPU tensors (K2's plain version): the neighbourhood counts
    agree, and most points' covariances to 1e-3 (the E[xx] - mu mu^T
    cancellation makes near-isotropic neighbourhoods order-sensitive, as
    tests/test_torch_voxel.py holds them against the reference)."""
    from rolo_tpu_torch.voxel.knn import estimate_covariances

    rng = np.random.default_rng(9)
    pts = torch.tensor(_bench_tool().world(9, 8192, 6)[1])  # four noisy walls
    mask = torch.tensor(rng.random(8192) < 0.9)
    knn_moments.launches = 0
    got = estimate_covariances(pts.to(cuda), mask.to(cuda), k=20).cpu()
    want = estimate_covariances(pts, mask, k=20)
    assert knn_moments.launches >= 1 and torch.isfinite(got).all()
    close = ((got - want).abs() < 1e-3).all(dim=-1).all(dim=-1)
    assert float(close[mask].float().mean()) > 0.97
    assert torch.equal(got[~mask], want[~mask])


# The seventh slice on the card: batched mapping gives each sequence the
# bits it gets alone, at tools/torch_bench_batch_mapping.py's worlds and
# config (1,024 corner / 4,096 surface / 8,192 submap points, 32 keyframes).


def _bench_tool():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools",
                        "torch_bench_batch_mapping.py")
    spec = importlib.util.spec_from_file_location("torch_bench_batch_mapping", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _same_bits(got, want):
    from rolo_tpu_torch.ops.pytree import tree_leaves

    got, want = tree_leaves(got), tree_leaves(want)
    return len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("bsz", [1, 2, 5])
def test_batched_mapping_gives_each_instance_its_bits_on_card(cuda, bsz):
    """backend_step (3 steps), extract_submap, knn_indices and
    solve_pose_graph ("dense", "bcr") over B sequences, each instance
    bit-equal to the same call alone, on the card."""
    from rolo_tpu_torch.graph.solver import solve_pose_graph
    from rolo_tpu_torch.mapping.backend import backend_step, init_backend
    from rolo_tpu_torch.mapping.keyframes import extract_submap
    from rolo_tpu_torch.ops.pytree import tree_index
    from rolo_tpu_torch.pointcloud.cloud import PaddedCloud
    from rolo_tpu_torch.voxel.knn import knn_indices

    tool = _bench_tool()
    cfg = tool.config()
    st = cfg.static
    worlds = [tool.world(100 + b, st.max_surf_points, st.max_corner_points) for b in range(bsz)]
    batch = init_backend(cfg, cuda, batch=bsz)
    singles = [init_backend(cfg, cuda) for _ in range(bsz)]
    eye = torch.eye(3, device=cuda)
    for s in range(3):
        shift = np.array([(0.8 + 0.03 * b) * s for b in range(bsz)], np.float32)
        corner = torch.tensor(np.stack([c - [x, 0, 0] for (c, _), x in zip(worlds, shift)]),
                              dtype=torch.float32, device=cuda)
        surf = torch.tensor(np.stack([w - [x, 0, 0] for (_, w), x in zip(worlds, shift)]),
                            dtype=torch.float32, device=cuda)
        guess = torch.tensor(np.stack([[x + 0.01 * s, 0.0, 0.0] for x in shift]),
                             dtype=torch.float32, device=cuda)
        cm = torch.ones(corner.shape[:2], dtype=torch.bool, device=cuda)
        sm = torch.ones(surf.shape[:2], dtype=torch.bool, device=cuda)
        batch, out = backend_step(batch, PaddedCloud(corner, cm), PaddedCloud(surf, sm),
                                  PaddedCloud(surf, sm), eye.expand(bsz, 3, 3), guess, True,
                                  0.5 * s, cfg)
        for b in range(bsz):
            sf = PaddedCloud(surf[b], sm[b])
            singles[b], one = backend_step(singles[b], PaddedCloud(corner[b], cm[b]), sf, sf, eye,
                                           guess[b], True, 0.5 * s, cfg)
            assert _same_bits(tree_index(out, b), one), (s, b)
            assert _same_bits(tree_index(batch, b), singles[b]), (s, b)
    assert (batch.db.count == 3).all()

    m = cfg.mapping
    args = (m.surrounding_keyframe_search_radius, m.surrounding_keyframe_recency_sec,
            m.surrounding_keyframe_max_nearby, st.max_submap_points, st.max_submap_points,
            m.mapping_corner_leaf_size, m.mapping_surf_leaf_size)
    subs = extract_submap(batch.db, batch.xyz, 1.5, *args)
    for b in range(bsz):
        alone = extract_submap(singles[b].db, singles[b].xyz, 1.5, *args)
        assert all(torch.equal(x.xyz[b], y.xyz) and torch.equal(x.mask[b], y.mask)
                   for x, y in zip(subs, alone)), b

    query = subs[0].xyz[:, :600] + 0.05
    idx = knn_indices(query, subs[0].mask[:, :600], subs[1].xyz, subs[1].mask, 5, 256)
    for b in range(bsz):
        alone = knn_indices(query[b], subs[0].mask[b, :600], subs[1].xyz[b], subs[1].mask[b], 5,
                            256)
        assert torch.equal(idx[b], alone), b

    for method in ("dense", "bcr"):
        sol = solve_pose_graph(batch.graph, batch.db.rot, batch.db.trans, batch.db.count,
                               method=method)
        for b in range(bsz):
            one = singles[b]
            alone = solve_pose_graph(one.graph, one.db.rot, one.db.trans, one.db.count,
                                     method=method)
            assert _same_bits(tree_index(sol, b), alone), (method, b)
