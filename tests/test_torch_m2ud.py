"""The port on the repo's M2UD configuration (configs/m2ud/: a VLP-16 at
16 beams x 1,800 columns, radius-search loops only, the small robot's
vehicle) against the JAX reference on the CPU, the port on its plain
kernel versions:

- the 16 x 1,800 range image of a simulated VLP-16 scan;
- the ring and time inference of SlamSystem's ingest for clouds without
  those fields (a KITTI .bin directory), in its numpy and tensor forms,
  with the rings it folds together;
- chip_smoke.py's rosbag writer, read back by both packages into equal
  frames in the driver's ring order (ring 0 the lowest laser);
- ground segmentation in both ring orders;
- the radius-search loop closure with the configuration's loop values;
- the wheel-contact solve with its vehicle on a sloped ground;
- the pipeline as a whole: 5 scans through both packages' SlamSystem;
- VoxelMap's capacity and packed-bin coordinates.

The scans come from chip_smoke.py's phase 14 sequence (the port's
simulator on the CPU), a VLP-16 at the configuration's 1,800 columns."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (M2UD_BEAMS, M2UD_CONFIGS, M2UD_TOPIC, m2ud_scans, m2ud_sensor_height,
                        m2ud_sim_config, write_m2ud_bag)
from test_backend import SMALL
from test_torch_loop import _factors, _same_loops
from test_torch_prior import (_col0_points, _plane, _port_ring, _same_solution, _solve_both,
                              _split)
from test_torch_runtime import RUN_ROT_DEG, RUN_TRANS_M, STEP_ROT_DEG, STEP_TRANS_M, _close, _poses
from torch_parity import T, out_and_back, padded_raw, point_set_match, port_config

from rolo_tpu.config import load_config as jload_config
from rolo_tpu.mapping import backend as jbk
from rolo_tpu.pointcloud import projection as jproj
from rolo_tpu.pointcloud.ground_seg import segment_ground as j_segment_ground
from rolo_tpu.prior import ground as jgr
from rolo_tpu.runtime import slam as jslam_module
from rolo_tpu.runtime.dataset import frames_from_bag as jframes_from_bag
from rolo_tpu.runtime.slam import SlamSystem as JSlamSystem
from rolo_tpu.voxel import voxelmap as jvm

from rolo_tpu_torch.config import load_config
from rolo_tpu_torch.mapping import backend as bk
from rolo_tpu_torch.pointcloud import projection as proj
from rolo_tpu_torch.pointcloud.ground_seg import segment_ground
from rolo_tpu_torch.prior import ground as gr
from rolo_tpu_torch.prior import vehicle as ve
from rolo_tpu_torch.runtime import slam as slam_module
from rolo_tpu_torch.runtime.dataset import frames_from_bag
from rolo_tpu_torch.runtime.slam import SlamSystem
from rolo_tpu_torch.voxel import voxelmap as vm

# RoloConfig()'s back-end capacities cut to tests/fixtures/sim_bag/config.yaml's
# and the feature caps to what a 16 x 1,800 scan fills (~2,450 features), so
# the XLA:CPU programs stay small; the sensor keeps its full width and the
# raw slots hold a whole sweep (28,800 pixels)
SCALED = {"static.max_raw_points": 32768, "static.max_extracted_points": 32768,
          "static.max_corner_points": 1024, "static.max_surf_points": 3072,
          "static.max_feature_points": 4096, "static.max_voxels": 4096,
          "static.max_keyframes": 64, "static.max_submap_points": 4096,
          "static.max_loop_factors": 16, "static.max_prior_factors": 16,
          "static.knn_query_chunk": 256, "mapping.scan2map_max_iterations": 6}
N_SCANS = 5


def _configs(**overrides):
    """(port, JAX) configurations of configs/m2ud/'s pair with the same
    dotted overrides."""
    paths = list(M2UD_CONFIGS)
    return load_config(paths, overrides), jload_config(paths, overrides)


@pytest.fixture(scope="module")
def scans():
    """N_SCANS scans of phase 14's sequence as the bag holds them: (stamp,
    xyz, ring int32 with ring 0 the lowest laser, time f32, gt_rot,
    gt_trans)."""
    cfg, _ = _configs()
    return [(stamp, xyz, ring.astype(np.int32), rel, gt_rot, gt_trans)
            for stamp, xyz, ring, rel, gt_rot, gt_trans
            in m2ud_scans(m2ud_sim_config(cfg, N_SCANS), "cpu")]


def test_sequence_is_the_configuration_s_sensor(scans):
    """A VLP-16 at the configuration's 1,800 columns, 0.18 + 0.27 m above
    the ground (the wheels vehicle_com_z below the body, the lidar
    lidarOffsetTrans above it), about 16,600 returns a scan."""
    cfg, _ = _configs()
    assert cfg.sensor.n_scan == M2UD_BEAMS and cfg.sensor.horizon_scan == 1800
    assert m2ud_sensor_height(cfg) == pytest.approx(0.45)
    sim = m2ud_sim_config(cfg, N_SCANS)
    assert sim.n_cols == 1800 and sim.sensor == "velodyne16"
    _, xyz, ring, _, _, _ = scans[0]
    assert 15000 < len(xyz) <= 16 * 1800
    assert sorted(set(ring.tolist())) == list(range(M2UD_BEAMS))


def test_driver_ring_order_is_lowest_laser_first(scans):
    """Ring 0 is the VLP-16's lowest laser (-15 deg), ring 15 its highest:
    each ring's median elevation rises with the ring."""
    _, xyz, ring, _, _, _ = scans[0]
    elev = np.degrees(np.arctan2(xyz[:, 2], np.linalg.norm(xyz[:, :2], axis=1)))
    med = np.array([np.median(elev[ring == r]) for r in range(M2UD_BEAMS)])
    assert np.all(np.diff(med) > 1.0)
    np.testing.assert_allclose(med[[0, -1]], [-15.0, 15.0], atol=1.0)


def test_projection_matches_reference(scans):
    """A 16 x 1,800 scan in configs/m2ud's range image: the reference's
    pixels with the reference's points, and one pixel per return kept by the
    range limits (1,800 columns: no power of two)."""
    cfg, _ = _configs()
    s = cfg.sensor
    _, xyz, ring, rel, _, _ = scans[0]
    raw = padded_raw(xyz, ring, rel, cfg.static.max_raw_points)
    args = (s.n_scan, s.horizon_scan, s.lidar_min_range, s.lidar_max_range, s.downsample_rate)
    got = proj.project_scan(proj.RawScan(*(T(a) for a in raw)), *args)
    want = jproj.project_scan(jproj.RawScan(*raw), *args)
    assert got.mask.shape == (16, 1800)
    in_range = np.linalg.norm(xyz, axis=1) >= s.lidar_min_range
    assert int(got.mask.sum()) > 0.97 * in_range.sum()
    for name in ("mask", "count", "col", "xyz", "rng"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)


def test_inferred_rings_and_times_match_reference(scans):
    """A cloud without ring and time fields (the KITTI .bin recipe): the
    rings SlamSystem infers assume +15 / -25 deg whatever the sensor, so a
    VLP-16's 16 beams fold into 12 rings, top first, and rings 12-15 stay
    empty; both packages infer the same rings and times, in numpy and for a
    tensor (a frame already on the card) in SlamSystem._make_raw_scan. At
    the beams' exact elevations the fold is [0 1 2 2 3 4 4 5 6 7 8 8 9 10
    10 11] top first; four beams lie halfway between two rings, and the
    range noise splits each of them, so the rings of those points depend on
    the last bit of the f32 arithmetic (computed by torch, ~0.6% of a scan's
    points took the other ring)."""
    cfg, jcfg = _configs(**SCALED)
    _, xyz, ring, _, _, _ = scans[0]
    n, period = cfg.sensor.n_scan, cfg.sensor.scan_period
    want_r = np.asarray(jslam_module.infer_rings(xyz, n))
    want_t = np.asarray(jslam_module.infer_rel_time(xyz, period))
    np.testing.assert_array_equal(slam_module.infer_rings(xyz, n), want_r)
    np.testing.assert_array_equal(slam_module.infer_rel_time(xyz, period), want_t)
    want = JSlamSystem(jcfg)._make_raw_scan(xyz, None, None)
    got = SlamSystem(cfg, "cpu")._make_raw_scan(T(xyz), None, None)
    for name in ("xyz", "ring", "rel_time", "mask"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)),
                                      err_msg=name)
    np.testing.assert_array_equal(got.ring.numpy()[:len(xyz)], want_r)
    assert sorted(set(want_r.tolist())) == list(range(12))
    median = [int(np.median(want_r[ring == b])) for b in range(M2UD_BEAMS)]
    assert median[::-1] == sorted(median[::-1])  # the highest laser has ring 0
    fold = np.round((15.0 - np.linspace(15.0, -15.0, 16)) / 40.0 * 15.0).astype(int)
    assert fold.tolist() == [0, 1, 2, 2, 3, 4, 4, 5, 6, 7, 8, 8, 9, 10, 10, 11]
    for b, r in enumerate(fold[::-1]):  # driver ring b is the (15 - b)-th beam from the top
        assert abs(median[b] - r) <= 1


def test_bag_reads_back_equal_in_both_packages(tmp_path):
    """chip_smoke.py's writer: a rosbag v2 of VLP-16 PointCloud2 messages
    (x y z intensity ring time) that both packages' frames_from_bag read
    into the same stamps, points, rings and times, the rings in the
    driver's order and the times f32 seconds from the sweep's start."""
    cfg, _ = _configs()
    sim = m2ud_sim_config(cfg, 2)
    write_m2ud_bag(str(tmp_path), sim, "cpu")
    bag = str(tmp_path / "seq.bag")
    got = list(frames_from_bag(bag, topic=M2UD_TOPIC))
    want = list(jframes_from_bag(bag, topic=M2UD_TOPIC))
    sent = list(m2ud_scans(sim, "cpu"))
    assert len(got) == len(want) == 2
    for g, w, (stamp, xyz, ring, rel, _, _) in zip(got, want, sent):
        assert g.stamp == w.stamp == pytest.approx(stamp, abs=1e-6)
        for name in ("points", "ring", "rel_time"):
            a, b = getattr(g, name), getattr(w, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b, err_msg=name)
        np.testing.assert_array_equal(g.points, xyz)
        np.testing.assert_array_equal(g.ring, ring)
        np.testing.assert_array_equal(g.rel_time, rel)
        assert g.rel_time.dtype == np.float32 and 0.0 <= g.rel_time.min() < g.rel_time.max() < 0.1
    assert (tmp_path / "gt_tum.txt").exists()


def _flat_scan(top_first: bool):
    """One VLP-16 sweep of flat ground 0.45 m below the sensor, the rings
    numbered top first (the simulator's order) or lowest first (a Velodyne
    driver's), as a padded raw scan."""
    elev = np.radians(np.linspace(15.0, -15.0, 16))
    az = np.radians(np.arange(1800) * 0.2)
    e, a = np.meshgrid(elev, az, indexing="ij")
    down = e < 0
    rng = np.where(down, 0.45 / np.sin(np.abs(np.where(down, e, -1.0))), 0.0)
    xyz = np.stack([rng * np.cos(e) * np.cos(a), rng * np.cos(e) * np.sin(a),
                    rng * np.sin(e)], -1).astype(np.float32)
    ring = np.broadcast_to(np.arange(16)[:, None] if top_first else 15 - np.arange(16)[:, None],
                           e.shape)
    keep = down & (rng <= 60.0)
    return padded_raw(xyz[keep], ring[keep].astype(np.int32),
                      np.zeros(int(keep.sum()), np.float32), 32768)


@pytest.mark.parametrize("order", ["driver", "simulator"])
def test_segment_ground_in_both_ring_orders(order):
    """Flat ground under a VLP-16 at 0.45 m through both packages'
    projection and segment_ground with the default eligible rings
    (n_scan // 2 = 8, rings 0-7): the same ground points outside column 0
    (the reference writes padding over column 0, tests/test_torch_prior.py).
    Only the driver's order (ring 0 the lowest laser) puts the eligible
    rings below the horizon; in the simulator's order (ring 0 the top
    beam) rings 0-7 look upward and see no ground, so a sensor recorded
    top first would feed the live ground map nothing."""
    cfg, _ = _configs()
    s = cfg.sensor
    raw = _flat_scan(order == "simulator")
    args = (s.n_scan, s.horizon_scan, s.lidar_min_range, s.lidar_max_range, s.downsample_rate)
    img = jproj.project_scan(jproj.RawScan(*(jnp.asarray(a) for a in raw)), *args)
    rings, cap = s.n_scan // 2, s.n_scan * s.horizon_scan
    want = j_segment_ground(img, s.horizon_scan, rings, 10.0, cap)
    got = segment_ground(_port_ring(img), s.horizon_scan, rings, 10.0, cap)
    col0 = _col0_points(img)
    w0, w_rest = _split(want, col0)
    g0, g_rest = _split(got, col0)
    np.testing.assert_array_equal(g_rest, w_rest)
    assert all(tuple(p) in col0 for p in g0)
    if order == "driver":
        # the seven lasers from -13 to -1 deg (-15 falls inside the 2 m
        # minimum range), every column
        assert len(g_rest) > 0.95 * 7 * (s.horizon_scan - 1)
        np.testing.assert_allclose(g_rest[:, 2], -0.45, atol=1e-5)
    else:
        assert len(g_rest) == len(g0) == 0


def test_ground_update_keeps_the_two_nearest_rings(scans):
    """runtime/cycles.ground_update's segmentation and live-map slot for
    phase 14's first scan, in both packages: segment_ground fills its
    output capacity (4 x live_ground_slot_points = 2,048) in grid order,
    ring 0 first, and in the driver's order rings 1-2 (-13 and -11 deg;
    -15 deg falls inside the 2 m minimum range) fill it, so the ground
    kept lies within 2.5 m and the 0.4 m downsample leaves ~60 points. The
    prior cycle looks for ground around the pose propagate_horizon_m (8 m)
    ahead and finds none: in both packages this configuration records no
    prior observation. The same points outside column 0; the reference
    adds its column-0 origin point (tests/test_torch_prior.py), which also
    moves the mean of the voxel it joins."""
    cfg, jcfg = _configs()
    s, st = cfg.sensor, cfg.static
    _, xyz, ring, rel, _, _ = scans[0]
    raw = padded_raw(xyz, ring, rel, st.max_raw_points)
    args = (s.n_scan, s.horizon_scan, s.lidar_min_range, s.lidar_max_range, s.downsample_rate)
    img = jproj.project_scan(jproj.RawScan(*(jnp.asarray(a) for a in raw)), *args)
    seg = (s.horizon_scan, s.n_scan // 2, cfg.prior.ground_seg_slope_deg,
           st.live_ground_slot_points * 4)
    want, got = j_segment_ground(img, *seg), segment_ground(_port_ring(img), *seg)
    col0 = _col0_points(img)
    _, w_rest = _split(want, col0)
    g0, g_rest = _split(got, col0)
    np.testing.assert_array_equal(g_rest, w_rest)
    assert int(got.mask.sum()) == int(np.asarray(want.mask).sum()) == st.live_ground_slot_points * 4
    assert np.linalg.norm(g_rest[:, :2], axis=1).max() < 2.5
    assert int(np.asarray(img.mask).sum(axis=1)[1:3].sum()) > st.live_ground_slot_points * 4
    eye, zero = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    slot = st.live_ground_slot_points
    jlive = jgr.update_live_ground(jgr.init_live_ground(st.live_ground_slots, slot), want,
                                   jnp.asarray(eye), jnp.asarray(zero), slot)
    live = gr.update_live_ground(gr.init_live_ground(st.live_ground_slots, slot, "cpu"), got,
                                 T(eye), T(zero), slot)
    jpts = np.asarray(jlive.xyz)[np.asarray(jlive.mask)]
    pts = live.xyz.numpy()[live.mask.numpy()]
    jpts = jpts[jpts.any(axis=1)]  # the reference's origin point
    assert 40 < len(pts) == len(jpts) < 100
    # voxel means: a voxel that took the reference's column-0 origin point moves
    assert point_set_match(pts, jpts, 1e-5) > 0.9 and point_set_match(pts, jpts, 0.01) == 1.0
    assert np.linalg.norm(pts[:, :2], axis=1).max() < 2.5 < cfg.filter.propagate_horizon_m


def test_loop_closure_step_with_m2ud_loop_values():
    """configs/m2ud's loop values (radius search only, 30 m, 30 s, 25
    keyframes a side, fitness 0.3) on the out-and-back world with the
    keyframes 3 s apart, so the return (keyframe 13, 39 s) is more than 30
    s after the start: both packages close the same radius-search loop
    (13, 0) with the same factor, to tests/test_torch_loop.py's
    tolerances; a second pass finds the keyframe matched."""
    _, jm2ud = _configs()
    assert jm2ud.loop.loop_close_type == "rs"
    jcfg = dataclasses.replace(SMALL, loop=jm2ud.loop)
    jstate = out_and_back(jcfg)
    jstate = jstate._replace(db=jstate.db._replace(time=jstate.db.time * 3.0))
    want, wclosed = jbk.loop_closure_step(jstate, jcfg)
    state = bk.backend_state_from_numpy(bk.backend_state_to_numpy(jstate), "cpu")
    got, closed = bk.loop_closure_step(state, port_config(jcfg))
    assert bool(closed) == bool(wclosed)
    assert _factors(got.graph.loops) == _factors(want.graph.loops) == [(13, 0)]
    _same_loops(got, want)
    assert float(got.graph.loops.robust_c[0]) == 0.0  # the radius search's plain noise
    again, closed_again = bk.loop_closure_step(got, port_config(jcfg))
    want_again, _ = jbk.loop_closure_step(want, jcfg)
    assert not bool(closed_again)
    _same_loops(again, want_again)


@pytest.mark.parametrize("normal,x,y,yaw", [((0.08, -0.05, 1.0), 0.0, 0.0, 0.4),
                                            ((-0.15, 0.0, 1.0), 2.0, -1.0, -1.2)])
def test_solve_pose_with_m2ud_vehicle(normal, x, y, yaw):
    """The small robot (wheels at +-0.4 / +-0.25 m, com 0.18 m up) on a
    sloped ground patch: the same solution in both packages, and the body
    resting on the plane (its z the plane's height plus vehicle_com_z
    along the normal, its tilt the plane's)."""
    _, jcfg = _configs()
    prior = jcfg.prior
    assert prior.wheel_xy == ((-0.4, 0.25), (0.4, 0.25), (0.4, -0.25), (-0.4, -0.25))
    pts = _plane(normal=normal, d=0.3, extent=6.0, n=8192, noise=0.005)
    got, want = _solve_both(pts, x, y, yaw, cfg=prior)
    _same_solution(got, want)
    assert bool(got.success) and bool(got.converged)
    nrm = np.asarray(normal) / np.linalg.norm(normal)
    ground_z = (0.3 - normal[0] * x - normal[1] * y) / normal[2]
    assert float(got.z) == pytest.approx(ground_z + prior.vehicle_com_z / nrm[2], abs=0.02)
    body_up = got.rot.numpy() @ np.array([0.0, 0.0, 1.0])
    assert np.degrees(np.arccos(np.clip(body_up @ nrm, -1.0, 1.0))) < 1.0


# The LM system of a contact solve on phase 14's live ground map (the
# port's SlamSystem over the sequence's first 80 scans on the CPU, prior
# tick 7, LM iteration 2; query x 9.1188, y 6.4614, yaw 1.4051): no ground
# point within 0.3 m of a wheel, condition number 8.9e5.
SPARSE_GROUND_SYSTEM = (
    [[6400.25, -27618.662109375, 24868.5859375],
     [-27618.662109375, 119187.796875, -107316.515625],
     [24868.5859375, -107316.515625, 96634.609375]],
    [6327.83447265625, -27307.181640625, 24588.240234375])


def _backward_error(a, b, x):
    a, b, x = (np.asarray(t, np.float64) for t in (a, b, x))
    return np.linalg.norm(a @ x - b) / (np.linalg.norm(a) * np.linalg.norm(x) + np.linalg.norm(b))


@pytest.mark.parametrize("case,lam", [("sparse_ground", None), ("rank2", 1.0), ("rank2", 0.1),
                                      ("rank2", 0.01)])
def test_contact_solve_step_matches_reference_lu(case, lam):
    """The contact solver's 3x3 LM step (`prior/vehicle._solve3`) on
    ill-conditioned systems: the reference solves them by LU
    (jnp.linalg.solve, vehicle.py:191-193), whose backward error stays at
    f32 round-off. The port's step keeps it under 1e-6 and lands within
    cond x 6e-8 of the float64 solution, as the reference's does. The
    adjugate formula the port used before lost every digit on the
    sparse-ground system (backward error 0.96, the step 100x off), so on
    phase 14's sequence the port's contact solves failed where the
    reference's succeeded (2 of 32 prior ticks against 32 of 32 on the
    same ground maps)."""
    if case == "sparse_ground":
        a, b = (np.asarray(t, np.float32) for t in SPARSE_GROUND_SYSTEM)
    else:
        # J^T J + lam I with J of rank 2 (two rows nearly parallel, as the
        # sparse-ground Jacobians' roll and pitch rows), lam down to where
        # f32 still holds it (cond ~ 3e7 at 0.01)
        rng = np.random.default_rng(3)
        j = rng.normal(0.0, 40.0, (3, 3))
        j[2] = 5.8 * j[1] + rng.normal(0.0, 1e-3, 3)
        a = (j.T @ j + lam * np.eye(3)).astype(np.float32)
        b = (-(j.T @ rng.normal(0.0, 10.0, 3))).astype(np.float32)
    x, ok = ve._solve3(T(a), T(b))
    want = np.asarray(jnp.linalg.solve(jnp.asarray(a), jnp.asarray(b)))
    exact = np.linalg.solve(a.astype(np.float64), b.astype(np.float64))
    bound = np.linalg.cond(a.astype(np.float64)) * 6e-8
    assert bool(ok)
    err = _backward_error(a, b, x.numpy())
    assert err < 1e-6, f"backward error {err:.2e}"
    assert _backward_error(a, b, want) < 1e-6
    for got in (x.numpy(), want):
        assert np.linalg.norm(got - exact) <= max(bound, 1e-6) * np.linalg.norm(exact)


@pytest.fixture(scope="module")
def runs(scans):
    """The same N_SCANS scans through both packages' SlamSystem with
    configs/m2ud's pair (deskew on, priors at 5 Hz, radius-search loops,
    mapping at the 0.15 s cadence), the capacities SCALED. (system,
    per-scan poses) per package."""
    cfg, jcfg = _configs(**SCALED)
    assert cfg.sensor.deskew_enabled and cfg.prior.enable and cfg.loop.loop_close_type == "rs"
    out = {}
    for name, slam in (("jax", JSlamSystem(jcfg)), ("port", SlamSystem(cfg, "cpu"))):
        poses = [_poses(slam.process_scan(xyz, stamp, ring=ring, rel_time=rel))
                 for stamp, xyz, ring, rel, _, _ in scans]
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
    """The same keyframes (stamps equal, positions within the run bound)
    and the same stages run as often, loop ticks included."""
    (jslam, _), (slam, _) = runs["jax"], runs["port"]
    assert int(slam.backend_state.db.count) == int(jslam.backend_state.db.count) >= 2
    kt, kp, _ = slam.keyframe_trajectory()
    jkt, jkp, _ = jslam.keyframe_trajectory()
    np.testing.assert_allclose(kt, jkt, atol=1e-6)
    np.testing.assert_allclose(kp, jkp, atol=RUN_TRANS_M)
    got = {k: v["count"] for k, v in slam.timers.summary().items()}
    want = {k: v["count"] for k, v in jslam.timers.summary().items()}
    assert got == want and {"frontend", "backend", "loop_closure"} <= set(got)


def test_slam_front_end_follows_the_motion(scans, runs):
    """The port's front-end positions within 0.1 m of the simulated motion,
    in the first scan's sensor frame."""
    slam, _ = runs["port"]
    gt = np.stack([s[5] for s in scans])
    gt0 = (gt - gt[0]) @ scans[0][4]
    assert np.linalg.norm(slam.front_positions_np() - gt0, axis=1).max() < 0.1


@pytest.mark.parametrize("polar,capacity", [(True, 2048), (False, 2048), (True, 256),
                                            (False, 256)])
def test_voxel_map_capacity_and_coord_match_reference(scans, polar, capacity):
    """VoxelMap.capacity and VoxelMap.coord(polar) (voxelmap.py:133-139) on
    one table the reference built from a scan's points: the same table
    slots and the same [V, 3] bins recovered from its packs, as a batch of
    one in the port; full-capacity and compacted tables alike."""
    _, xyz, _, _, _, _ = scans[0]
    pts = np.zeros((2048, 3), np.float32)
    pts[:] = xyz[::8][:2048]
    mask = np.ones(2048, bool)
    mask[-100:] = False
    pts[~mask] = 0.0
    cov = np.tile(np.array([1.0, 0, 0, 1.0, 0, 1.0], np.float32)[:, None], (1, 2048))
    kw = dict(polar_res=jnp.asarray((0.175, 0.175, 2.0))) if polar else \
        dict(polar_res=None, resolution=0.5)
    jm = jvm.build_voxel_map(jnp.asarray(pts), jnp.asarray(cov), jnp.asarray(mask), capacity,
                             **kw)
    tm = vm.VoxelMap(*(T(np.asarray(getattr(jm, f)))[None] for f in vm.VoxelMap._fields))
    assert tm.capacity == jm.capacity == capacity
    got, want = tm.coord(polar), np.asarray(jm.coord(polar))
    assert got.shape == (1, capacity, 3) and got.dtype == torch.int32
    np.testing.assert_array_equal(got[0].numpy(), want)
    valid = np.asarray(jm.valid)
    assert valid.sum() > 10
    pack = vm.pack_polar(got) if polar else vm.pack_uniform(got)
    np.testing.assert_array_equal(pack[0].numpy()[valid], np.asarray(jm.pack)[valid])
