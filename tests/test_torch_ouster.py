"""The port on the repo's Ouster OS-64 configuration (configs/params_os.yaml:
64 beams x 2,048 columns, 24,576 feature slots, 16,384 voxels) against the
JAX reference on the CPU, the port on its plain kernel versions:

- Ouster PCD ingest (x y z F4, t U4 nanoseconds, ring U2): both packages'
  frames_from_dir give bit-equal points, rings and times, and equal stamps;
  the range image at 64 x 2,048 holds every return, as the reference's;
- the raw-capacity truncation of SlamSystem._make_raw_scan: the first
  max_raw_points returns in file order, as the reference keeps them;
- LOAM features of 64-beam scans at params_os.yaml's thresholds, as sets;
- the pipeline as a whole: the same 64-beam scans through both packages'
  SlamSystem with params_os.yaml's deskew and prior_pose_params.yaml's
  priors, per-scan poses within tests/test_torch_runtime.py's tolerances.

The scans come from chip_smoke.py's 64-beam sensor (the OS-64's field of
view) at 256 columns; where a test runs the pipeline, the configuration's
capacities are cut by the same factor of 2,048 / 256."""

import collections

import numpy as np
import pytest

import test_dataset
from chip_smoke import OUSTER_CONFIGS, ouster_scans, ouster_sim_config, write_ouster_pcd
from test_torch_runtime import RUN_ROT_DEG, RUN_TRANS_M, STEP_ROT_DEG, STEP_TRANS_M, _close, _poses
from torch_parity import T, jax_features, padded_raw, point_set_match, torch_features

from rolo_tpu.config import load_config as jload_config
from rolo_tpu.pointcloud import projection as jproj
from rolo_tpu.runtime.dataset import frames_from_dir as jframes_from_dir
from rolo_tpu.runtime.slam import SlamSystem as JSlamSystem

from rolo_tpu_torch.config import load_config
from rolo_tpu_torch.pointcloud import projection as proj
from rolo_tpu_torch.runtime.dataset import frames_from_dir
from rolo_tpu_torch.runtime.slam import SlamSystem

N_COLS = 256
# params_os.yaml's capacities cut by 2,048 / N_COLS (max_raw_points keeps
# half a sweep, as the shipped 65,536 of 131,072 pixels do), and the back-end
# ones at tests/fixtures/sim_bag/config.yaml's, so the XLA:CPU programs stay
# small
SCALED = {"sensor.horizon_scan": N_COLS, "static.max_raw_points": 8192,
          "static.max_extracted_points": 4096, "static.max_corner_points": 512,
          "static.max_surf_points": 1536, "static.max_feature_points": 3072,
          "static.max_voxels": 2048, "static.max_keyframes": 64,
          "static.max_submap_points": 4096, "static.max_loop_factors": 16,
          "static.max_prior_factors": 16, "static.knn_query_chunk": 256,
          "mapping.scan2map_max_iterations": 6}
N_SCANS = 5

Frame = collections.namedtuple("Frame", "stamp points ring rel_time gt_rot gt_trans")


def _configs(**overrides):
    """(port, JAX) configurations of params_os.yaml + prior_pose_params.yaml
    with the same dotted overrides."""
    paths = list(OUSTER_CONFIGS)
    return load_config(paths, overrides), jload_config(paths, overrides)


@pytest.fixture(scope="module")
def scans():
    """N_SCANS simulated 64-beam scans at N_COLS columns, as the Ouster PCD
    ingest hands them on: rings int32, times in f32 seconds from the t
    field's nanoseconds."""
    out = []
    for stamp, xyz, t_ns, ring, gt_rot, gt_trans in ouster_scans(
            ouster_sim_config(N_SCANS, N_COLS), "cpu"):
        rel = (t_ns.astype(np.float64) * 1e-9).astype(np.float32)
        out.append(Frame(stamp, xyz, ring.astype(np.int32), rel, gt_rot, gt_trans))
    return out


def _write_fixture(d):
    """tests/test_dataset.py's Ouster fixture (64 beams x 256 columns)."""
    test_dataset.TestOusterIngest()._write_ouster_pcd(str(d / "0000000001.000000.pcd"))


def _write_simulated(d):
    """chip_smoke.py's writer on one simulated 64-beam scan."""
    stamp, xyz, t_ns, ring, _, _ = next(ouster_scans(ouster_sim_config(1, N_COLS), "cpu"))
    write_ouster_pcd(str(d / f"{stamp:017.6f}.pcd"), xyz, t_ns, ring)


@pytest.mark.parametrize("write", [_write_fixture, _write_simulated],
                         ids=["test_dataset_fixture", "chip_smoke_writer"])
def test_ouster_pcd_ingest_bit_equal(tmp_path, write):
    write(tmp_path)
    (got,), (want,) = list(frames_from_dir(str(tmp_path))), list(jframes_from_dir(str(tmp_path)))
    assert got.stamp == want.stamp == 1.0
    for name in ("points", "ring", "rel_time"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.ring.max() == 63 and got.rel_time.dtype == np.float32
    assert 0.0 <= got.rel_time.min() and got.rel_time.max() < 0.1


def test_ouster_projection_matches_reference(tmp_path):
    """The fixture's returns in params_os.yaml's 64 x 2,048 range image:
    more than 95% of them land (one per ring and column, as the JAX test
    requires), in the reference's pixels with the reference's points."""
    _write_fixture(tmp_path)
    (f,) = list(frames_from_dir(str(tmp_path)))
    cfg, _ = _configs()
    s = cfg.sensor
    raw = padded_raw(f.points, f.ring, f.rel_time, cfg.static.max_raw_points)
    args = (s.n_scan, s.horizon_scan, s.lidar_min_range, s.lidar_max_range, s.downsample_rate)
    got = proj.project_scan(proj.RawScan(*(T(a) for a in raw)), *args)
    want = jproj.project_scan(jproj.RawScan(*raw), *args)
    assert got.mask.shape == (64, 2048)
    assert int(got.mask.sum()) / len(f.points) > 0.95
    for name in ("mask", "count", "col", "xyz", "rng"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)


@pytest.mark.parametrize("kind", ["numpy", "numpy_inferred", "tensor"])
def test_raw_truncation_matches_reference(scans, kind):
    """A scan of more returns than max_raw_points (4,096 here): both
    packages keep its first 4,096 in file order, the top rings of a
    beam-major cloud, with the same mask. "numpy_inferred" passes no ring
    and time fields (both inferred from the points); "tensor" hands the port
    a tensor, as a frame already on the card."""
    cap = 4096
    cfg, jcfg = _configs(**{**SCALED, "static.max_raw_points": cap})
    f = scans[0]
    assert len(f.points) > cap
    ring, rel = (None, None) if kind == "numpy_inferred" else (f.ring, f.rel_time)
    want = JSlamSystem(jcfg)._make_raw_scan(f.points, ring, rel)
    slam = SlamSystem(cfg, "cpu")
    got = (slam._make_raw_scan(T(f.points), T(ring), T(rel)) if kind == "tensor"
           else slam._make_raw_scan(f.points, ring, rel))
    for name in ("xyz", "ring", "rel_time", "mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    assert int(got.mask.sum()) == cap
    np.testing.assert_array_equal(got.xyz.numpy(), f.points[:cap])
    if kind != "numpy_inferred":
        assert got.ring.numpy().max() < f.ring.max()  # the lowest rings are cut


@pytest.mark.parametrize("i", [0, 1])
def test_features_match_reference_as_sets(scans, i):
    """LOAM corners and surfaces of a 64-beam scan at params_os.yaml's
    thresholds and the cut capacities (the raw cap truncating the scan), as
    point sets: the slot order follows argsorts and may differ on ties. The
    tolerances are tests/test_torch_pointcloud.py's: counts within 2, 99.5%
    of the points within 1e-5 m of one of the other package's."""
    cfg, jcfg = _configs(**SCALED)
    assert cfg.features.edge_threshold == 1.0 and cfg.sensor.n_scan == 64
    f = scans[i]
    assert len(f.points) > cfg.static.max_raw_points
    jx, jm = jax_features([f], jcfg)
    tx, tm = torch_features([f], cfg)
    a, b = tx[0][tm[0]], jx[0][jm[0]]
    assert len(b) > 500
    assert abs(len(a) - len(b)) <= 2
    assert point_set_match(a, b, 1e-5) > 0.995
    assert point_set_match(b, a, 1e-5) > 0.995


@pytest.fixture(scope="module")
def runs(scans):
    """The same N_SCANS scans through both packages' SlamSystem: deskew on
    (params_os.yaml leaves it on), priors at 5 Hz, mapping at the 0.15 s
    cadence. (system, per-scan poses) per package."""
    cfg, jcfg = _configs(**SCALED)
    assert cfg.sensor.deskew_enabled and cfg.prior.enable
    out = {}
    for name, slam in (("jax", JSlamSystem(jcfg)), ("port", SlamSystem(cfg, "cpu"))):
        poses = [_poses(slam.process_scan(f.points, f.stamp, ring=f.ring, rel_time=f.rel_time))
                 for f in scans]
        slam.finalize()
        out[name] = (slam, poses)
    return out


def test_slam_poses_match_reference(runs):
    """Per-scan front-end, mapped and fused poses within
    test_torch_runtime.py's tolerances: its one-step bound for every scan
    but the last, its run bound for the last."""
    (_, want), (_, got) = runs["jax"], runs["port"]
    assert len(got) == len(want) == N_SCANS
    for i, (g, w) in enumerate(zip(got, want)):
        last = i == N_SCANS - 1
        _close(g, w, RUN_ROT_DEG if last else STEP_ROT_DEG,
               RUN_TRANS_M if last else STEP_TRANS_M, f"scan {i}")


def test_slam_keyframes_and_stages_match_reference(runs):
    """The same keyframes (stamps equal, positions within the run bound) and
    the same stages run as often."""
    (jslam, _), (slam, _) = runs["jax"], runs["port"]
    assert int(slam.backend_state.db.count) == int(jslam.backend_state.db.count) >= 2
    kt, kp, _ = slam.keyframe_trajectory()
    jkt, jkp, _ = jslam.keyframe_trajectory()
    np.testing.assert_allclose(kt, jkt, atol=1e-6)
    np.testing.assert_allclose(kp, jkp, atol=RUN_TRANS_M)
    got = {k: v["count"] for k, v in slam.timers.summary().items()}
    want = {k: v["count"] for k, v in jslam.timers.summary().items()}
    assert got == want and {"frontend", "backend"} <= set(got)


def test_slam_front_end_follows_the_motion(scans, runs):
    """The port's front-end positions within 0.2 m of the simulated motion,
    in the first scan's sensor frame."""
    slam, _ = runs["port"]
    gt = np.stack([f.gt_trans for f in scans])
    gt0 = (gt - gt[0]) @ scans[0].gt_rot
    assert np.linalg.norm(slam.front_positions_np() - gt0, axis=1).max() < 0.2
