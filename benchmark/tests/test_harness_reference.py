"""The plain references import nothing of the program, of JAX or of the
JAX package, and compute what the program's plain versions compute."""

from __future__ import annotations

import ast
import glob
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.harness import spec

REF_FILES = sorted(glob.glob(os.path.join(spec.BENCH_DIR, "reference", "**", "*.py"),
                             recursive=True))
YARDSTICK = REF_FILES + [os.path.join(spec.BENCH_DIR, "harness", f) for f in
                         ("sim.py", "stats.py", "checks.py")] + sorted(
    glob.glob(os.path.join(spec.BENCH_DIR, "roofline", "*.py")))


@pytest.mark.parametrize("path", YARDSTICK, ids=lambda p: os.path.relpath(p, spec.BENCH_DIR))
def test_imports_nothing_of_the_program(path):
    with open(path) as f:
        tree = ast.parse(f.read())
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        for name in names:
            assert name.split(".")[0] not in ("rolo_tpu_torch", "rolo_tpu", "jax", "jaxlib")


def test_reference_loads_no_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.featurize, benchmark.reference.kernels\n"
            "import benchmark.reference.steps.frontend.odometry\n"
            "import benchmark.harness.checks, benchmark.harness.sim\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('rolo_tpu_torch', 'rolo_tpu', 'jax')))\n" % spec.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _cloud(rng, b, n):
    xyz = torch.as_tensor(rng.normal(size=(b, n, 3)).astype(np.float32) * 3 + 20)
    mask = torch.as_tensor(rng.random((b, n)) < 0.9)
    return torch.where(mask[..., None], xyz, 0.0), mask


def test_kernel_references_match_the_programs_plain_versions():
    from benchmark.reference import kernels as ref
    from rolo_tpu_torch.ops import knn_moments as k2
    from rolo_tpu_torch.ops import voxel_join as k1

    rng = np.random.default_rng(0)
    xyz, mask = _cloud(rng, 2, 300)
    xc = torch.as_tensor(rng.normal(size=(2, 10, 300)).astype(np.float32)) * mask[:, None]
    want = k2.knn_moments_torch(xyz, mask, xyz, mask, xc, 20)
    assert torch.equal(ref.knn_moments(xyz, mask, xyz, mask, xc, 20), want)
    keys = torch.as_tensor(rng.integers(0, 50, size=(2, 300)).astype(np.int32))
    keys_m = torch.as_tensor(rng.integers(0, 60, size=(2, 200)).astype(np.int32))
    keys_m[:, :5] = k1.INVALID_PACK
    vals = torch.as_tensor(rng.normal(size=(2, 7, 300)).astype(np.float32))
    assert torch.equal(ref.keyed_matmul(vals, keys, keys_m),
                       k1.keyed_matmul_torch(vals, keys, keys_m))


def test_featurize_reference_matches_the_programs():
    from benchmark.harness import checks, sim
    from benchmark.tests.tiny import tiny_cell
    from rolo_tpu_torch.pointcloud.features import extract_features
    from rolo_tpu_torch.pointcloud.projection import RawScan, project_scan

    cell = tiny_cell("stream")
    cfg = spec.resolve_config(cell.config)
    scan = sim.sequence(7, cell.config["sensor"], cell.traffic["world"], 1, "cpu")[0]
    ref = checks.reference_features(scan, cfg, "cpu")
    st, s, f = cfg.static, cfg.sensor, cfg.features
    m = min(len(scan.xyz), st.max_raw_points)
    pad = lambda a, dt: torch.cat([torch.as_tensor(a[:m]), torch.zeros(
        (st.max_raw_points - m,) + a.shape[1:], dtype=dt)])
    raw = RawScan(pad(scan.xyz, torch.float32), pad(scan.ring, torch.int32),
                  pad(scan.rel_time, torch.float32), torch.arange(st.max_raw_points) < m)
    img = project_scan(raw, s.n_scan, s.horizon_scan, s.lidar_min_range, s.lidar_max_range,
                       s.downsample_rate)
    got = extract_features(img, f.edge_threshold, f.surf_threshold, f.odometry_surf_leaf_size,
                           st.max_corner_points, st.max_surf_points)
    assert int(got.corners.mask.sum()) > 0 and int(got.surfaces.mask.sum()) > 0
    assert checks.cloud_gap(got.corners.xyz, got.corners.mask, ref.corners.xyz,
                            ref.corners.mask) == 0.0
    assert checks.cloud_gap(got.surfaces.xyz, got.surfaces.mask, ref.surfaces.xyz,
                            ref.surfaces.mask) == 0.0
    moved = got.surfaces.xyz + 0.01
    assert checks.cloud_gap(moved, got.surfaces.mask, ref.surfaces.xyz, ref.surfaces.mask) > 1.0


def _two_featurized_scans():
    from benchmark.harness import sim
    from benchmark.tests.tiny import tiny_cell
    from rolo_tpu_torch.bench import featurize_parts
    from rolo_tpu_torch.sim.dataset import SimFrame

    cell = tiny_cell("stream")
    cfg = spec.resolve_config(cell.config)
    scans = sim.sequence(7, cell.config["sensor"], cell.traffic["world"], 2, "cpu")
    parts = [featurize_parts(SimFrame(s.stamp, torch.as_tensor(s.xyz), torch.as_tensor(s.ring),
                                      torch.as_tensor(s.rel_time), None, None), cfg)[0]
             for s in scans]
    return cell, cfg, parts


def test_step_reference_matches_the_programs_step():
    """In float32 the frozen step computes what the program's does on the
    CPU (the same plain kernels); in float64 it stays close."""
    from benchmark.harness import checks
    from benchmark.reference import steps
    from rolo_tpu_torch.frontend import odometry
    from rolo_tpu_torch.pointcloud.cloud import concat_clouds

    cell, cfg, parts = _two_featurized_scans()
    st, reg = cfg.static, cfg.registration
    feats = [concat_clouds(p.corners, p.surfaces, st.max_feature_points) for p in parts]
    state = odometry.init_state(st.max_feature_points, "cpu", batch=1)
    state, _ = odometry.scan_step(state, feats[0].xyz[None], feats[0].mask[None], 0.1, reg,
                                  st.max_voxels, reg.k_correspondences)
    _, out = odometry.scan_step(state, feats[1].xyz[None], feats[1].mask[None], 0.1, reg,
                                st.max_voxels, reg.k_correspondences)
    pinned = cell.config["pinned"]
    ref_reg = steps.registration_config(pinned["registration"])
    assert float(torch.linalg.vector_norm(out.step_trans)) > 0.05  # the vehicle moved
    for dtype, tol in ((torch.float32, 1e-6), (torch.float64, 1e-3)):
        rot, trans = steps.frontend_step(state, feats[1].xyz[None], feats[1].mask[None], 0.1,
                                         ref_reg, st.max_voxels, reg.k_correspondences, False,
                                         dtype)
        assert float(checks.pose_gap(out.step_rot, out.step_trans, rot, trans).max()) < tol


def test_pose_gap_reads_translation_and_lever_arm():
    from benchmark.harness import checks
    from benchmark.harness.sim import rpy_to_matrix

    eye = torch.eye(3)[None]
    t0 = torch.zeros(1, 3)
    assert float(checks.pose_gap(eye, t0, eye, t0 + torch.tensor([0.3, 0.4, 0.0]))) == \
        pytest.approx(0.5)
    zero = torch.zeros((), dtype=torch.float64)
    rot = rpy_to_matrix(zero, zero, zero + 1e-3)[None]
    assert float(checks.pose_gap(eye.double(), t0, rot, t0)) == pytest.approx(
        checks.LEVER_M * 1e-3, rel=1e-6)


def test_output_gap_scales_by_plane():
    from benchmark.harness import checks

    want = torch.tensor([[[1.0, 2.0], [100.0, -200.0]]])
    got = want.clone()
    got[0, 1, 0] += 2.0
    assert checks.output_gap(got, want) == pytest.approx(0.01)
    assert checks.output_gap(want, want) == 0.0
