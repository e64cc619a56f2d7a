"""The port on the M2UD configuration's loop closure and deskew against the
benchmark's plain references (`benchmark/reference/loop.py`, float64,
written from the reference system's description; `reference/featurize.py`)
on the CPU, without JAX:

- `backend.loop_closure_step` with radius-search loops (`loop_close_type`
  "rs") on seeded random keyframe stores at small capacities: a revisit
  that verifies, a revisit of another world (fitness over
  `history_fitness_score`), no keyframe outside the time gate, and a latest
  keyframe that already owns a loop. The reference starts from the
  program's own detection inputs and assembled submaps, as the benchmark's
  `loop_check.py` does on the card.
- the deskewed `project_scan` of a 16 x 1,800 scan against the reference's
  with the same increment.
"""

import numpy as np
import pytest
import torch

from torch_parity import small_config

from benchmark.harness.checks import pose_gap
from benchmark.reference import featurize as ref_feat
from benchmark.reference import loop as ref_loop

from rolo_tpu_torch.geometry import so3
from rolo_tpu_torch.geometry.se3 import SE3
from rolo_tpu_torch.loop import closure as cl
from rolo_tpu_torch.mapping import backend as bk
from rolo_tpu_torch.mapping.keyframes import add_keyframe
from rolo_tpu_torch.pointcloud import projection as proj
from rolo_tpu_torch.pointcloud.cloud import PaddedCloud

N_KEYFRAMES = 26
RADIUS_M = 8.0  # the keyframes' circle; one lap in 24 keyframes, 1 s apart
TIME_DIFF_S = 10.0
# program (f32) against reference (f64) on a verified revisit, from the
# readings of this store on seeds 0-5: pose gap 5.2e-6-4.9e-4 m (translation
# + 30 m x rotation), fitness 1.1e-7-2.6e-6 relative; the reference in
# bfloat16 reads 0.059-0.071 m and a 1 cm error of the factor 0.0100-0.0103
# m. 2 mm lies 4x above the largest reading and 5x under both; 1e-4 lies
# 38x above the largest fitness reading.
POSE_GAP_M, FITNESS_REL = 2e-3, 1e-4


def _config(**overrides):
    """The fixture's capacities with the M2UD loop values (radius search
    only, 30 m radius, fitness 0.3), the time gate and the submap's
    neighbours cut to the small store."""
    return small_config(**{"loop.enable": True, "loop.loop_close_type": "rs",
                           "loop.history_search_time_diff": TIME_DIFF_S,
                           "loop.history_search_num": 2, **overrides})


def _world(rng, n_walls=7, n_poles=12):
    """A random outdoor world: (corner points, surface points) [N, 3] f32 in
    the world frame, the ground 0.45 m under the sensor's height."""
    ground = np.column_stack([rng.uniform(-30, 30, (2500, 2)),
                              rng.normal(-0.45, 0.01, 2500)])
    surfs, corners = [ground], []
    for _ in range(n_walls):
        r, th = rng.uniform(11, 24), rng.uniform(0, 2 * np.pi)
        d = rng.uniform(0, 2 * np.pi)
        s = rng.uniform(-5, 5, 250)
        z = rng.uniform(-0.4, 3.0, 250)
        wall = np.column_stack([r * np.cos(th) + s * np.cos(d), r * np.sin(th) + s * np.sin(d), z])
        surfs.append(wall + rng.normal(0, 0.01, wall.shape))
        corners.append(wall[np.abs(s) > 4.6])
    for _ in range(n_poles):
        r, th = rng.uniform(2, 24), rng.uniform(0, 2 * np.pi)
        if abs(r - RADIUS_M) < 1.5:
            r += 3.0
        z = rng.uniform(-0.4, 2.5, 40)
        pole = np.column_stack([np.full(40, r * np.cos(th)), np.full(40, r * np.sin(th)), z])
        corners.append(pole + rng.normal(0, 0.01, pole.shape))
    return (np.concatenate(corners).astype(np.float32),
            np.concatenate(surfs).astype(np.float32))


def _pose(i):
    """Keyframe i's true pose on the circle, heading along it."""
    th = 2 * np.pi * i / 24
    yaw = th + np.pi / 2
    return so3.rpy_to_matrix(*torch.tensor([0.0, 0.0, yaw])), torch.tensor(
        [RADIUS_M * np.cos(th), RADIUS_M * np.sin(th), 0.0], dtype=torch.float32)


def _store(seed, cfg, other_world_before=None):
    """A BackendState whose keyframes i = 0 .. N_KEYFRAMES - 1 (stamps i s)
    hold the world within 25 m in their sensor frame, each stored at its
    true pose moved by a drift that grows with i (2 cm in y and 3 mrad of
    yaw a keyframe). Keyframes before `other_world_before` see a second
    world of the same seed."""
    rng = np.random.default_rng(seed)
    worlds = [_world(rng), _world(rng)]
    st = cfg.static
    state = bk.init_backend(cfg, "cpu")
    db = state.db
    for i in range(N_KEYFRAMES):
        rot, trans = _pose(i)
        world = worlds[1 if other_world_before is not None and i < other_world_before else 0]

        def local(points, cap):
            p = (torch.from_numpy(points) - trans) @ rot
            p = p[torch.linalg.vector_norm(p, dim=-1) < 25.0]
            keep = torch.from_numpy(rng.permutation(p.shape[0])[:cap])
            return PaddedCloud.from_points(p[keep].numpy(), cap, "cpu")

        drift_rot = so3.rpy_to_matrix(*torch.tensor([0.0, 0.0, 3e-3 * i]))
        stored = SE3(drift_rot @ rot, trans + torch.tensor([0.0, 0.02 * i, 0.0]))
        db = add_keyframe(db, stored, float(i), local(world[0], st.max_corner_points),
                          local(world[1], st.max_surf_points))
    return state._replace(db=db)


def _taped(monkeypatch):
    """The operands and result of each `verify_loop` call."""
    calls = []
    real = cl.verify_loop

    def tap(db, cur_key, prev_key, cur_submap, prev_submap, init_yaw, **kwargs):
        out = real(db, cur_key, prev_key, cur_submap, prev_submap, init_yaw, **kwargs)
        calls.append(dict(db=db, cur=int(cur_key), prev=int(prev_key), cur_sub=cur_submap,
                          prev_sub=prev_submap, yaw=float(init_yaw), out=out, **kwargs))
        return out

    monkeypatch.setattr(cl, "verify_loop", tap)
    return calls


CASES = {
    "revisit_verifies": dict(seed=0),
    "other_world_rejected": dict(seed=1, other_world_before=6),
    "none_outside_the_gate": dict(seed=2, overrides={"loop.history_search_time_diff": 40.0}),
    "latest_already_matched": dict(seed=3, matched=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_radius_loop_closure_step_matches_the_plain_reference(monkeypatch, case):
    spec = CASES[case]
    cfg = _config(**spec.get("overrides", {}))
    lc = cfg.loop
    state = _store(spec["seed"], cfg, spec.get("other_world_before"))
    if spec.get("matched"):
        state.loop_matched[N_KEYFRAMES - 1] = True
    db = state.db
    want_prev = ref_loop.detect_radius(db.trans, db.time, int(db.count), state.loop_matched,
                                       lc.history_search_radius, lc.history_search_time_diff)
    calls = _taped(monkeypatch)
    new, closed = bk.loop_closure_step(state, cfg)
    loops = new.graph.loops
    if case in ("none_outside_the_gate", "latest_already_matched"):
        assert want_prev is None and not calls
        assert not bool(closed) and int(loops.count) == 0
        return
    # the candidate: the keyframe a lap back, the same as the reference's
    assert len(calls) == 1 and calls[0]["prev"] == want_prev == N_KEYFRAMES - 1 - 24
    c = calls[0]
    got = c["out"]
    cur_rot, cur_trans = c["db"].rot[c["cur"]], c["db"].trans[c["cur"]]
    prev_rot, prev_trans = c["db"].rot[c["prev"]], c["db"].trans[c["prev"]]
    want = ref_loop.verify(cur_rot, cur_trans, prev_rot, prev_trans, c["cur_sub"].xyz,
                           c["cur_sub"].mask, c["prev_sub"].xyz, c["prev_sub"].mask, c["yaw"],
                           c["max_corr_dist"], c["fitness_threshold"])
    assert bool(got.accepted) == want.accepted == (case == "revisit_verifies")
    assert bool(closed) == want.accepted and int(loops.count) == int(want.accepted)
    if not want.accepted:
        assert want.fitness > lc.history_fitness_score and float(got.noise_var[0]) > \
            lc.history_fitness_score
        return
    gap = float(pose_gap(loops.rel_rot[0], loops.rel_trans[0], want.rel_rot, want.rel_trans))
    fit_rel = abs(float(got.noise_var[0]) - want.variance) / want.variance
    assert gap < POSE_GAP_M and fit_rel < FITNESS_REL, (gap, fit_rel, want.iterations)
    # the factor joins the two keyframes and marks the current one matched
    assert (int(loops.i[0]), int(loops.j[0])) == (c["cur"], c["prev"])
    assert bool(new.loop_matched[c["cur"]])


def _scan(rng, n_scan=16, horizon=1800):
    """A VLP-16 sweep as the driver hands it over: one return a pixel at a
    random range, its azimuth jittered inside its column, rings lowest beam
    first, times across the 0.1 s sweep; 5% dropped."""
    elev = np.radians(np.linspace(-15.0, 15.0, n_scan))
    col = np.arange(horizon)
    az = np.radians(90.0 - 360.0 * (col - horizon // 2 + rng.uniform(-0.3, 0.3, (n_scan, horizon)))
                    / horizon)
    rng_m = rng.uniform(2.5, 38.0, (n_scan, horizon))
    xyz = np.stack([rng_m * np.cos(elev)[:, None] * np.sin(az),
                    rng_m * np.cos(elev)[:, None] * np.cos(az),
                    rng_m * np.sin(elev)[:, None]], -1).reshape(-1, 3)
    ring = np.repeat(np.arange(n_scan), horizon)
    rel = np.tile(0.1 * col / horizon, n_scan)
    keep = rng.random(len(xyz)) >= 0.05
    return xyz[keep].astype(np.float32), ring[keep].astype(np.int32), rel[keep].astype(np.float32)


@pytest.mark.parametrize("vel", [None, (0.22, -0.01, 0.005)])
def test_deskewed_projection_matches_the_plain_reference(vel):
    """The same raw scan and increment (a turn of ~0.5 deg and ~2 cm of
    travel over the sweep) give the same range image: every pixel and
    column equal, coordinates within 1e-5 m of the float64 reference."""
    cfg = small_config(**{"sensor.horizon_scan": 1800, "static.max_raw_points": 32768})
    s, cap = cfg.sensor, cfg.static.max_raw_points
    xyz, ring, rel = _scan(np.random.default_rng(7))
    m = len(xyz)
    pad = cap - m
    raw = proj.RawScan(torch.from_numpy(np.concatenate([xyz, np.zeros((pad, 3), np.float32)])),
                       torch.from_numpy(np.concatenate([ring, np.zeros(pad, np.int32)])),
                       torch.from_numpy(np.concatenate([rel, np.zeros(pad, np.float32)])),
                       torch.arange(cap) < m)
    rpy = torch.tensor([0.002, -0.003, 0.009])
    dt = torch.tensor(0.1)
    vel_t = None if vel is None else torch.tensor(vel)
    got = proj.project_scan(raw, s.n_scan, s.horizon_scan, s.lidar_min_range, s.lidar_max_range,
                            s.downsample_rate, deskew_rpy=rpy, odom_time_diff=dt,
                            deskew_vel=vel_t)
    ref_raw = ref_feat.RawScan(raw.xyz.double(), raw.ring, raw.rel_time.double(), raw.mask)
    want = ref_feat.project_scan(ref_raw, s.n_scan, s.horizon_scan, s.lidar_min_range,
                                 s.lidar_max_range, s.downsample_rate, deskew_rpy=rpy.double(),
                                 odom_time_diff=dt.double(),
                                 deskew_vel=None if vel_t is None else vel_t.double())
    assert int(got.count.sum()) > 0.9 * m
    assert torch.equal(got.count, want.count) and torch.equal(got.mask, want.mask)
    assert torch.equal(got.col, want.col)
    mask = want.mask
    assert float((got.xyz[mask].double() - want.xyz[mask]).abs().max()) < 1e-5
    # the deskew moved the points: the image is not the raw one
    plain = proj.project_scan(raw, s.n_scan, s.horizon_scan, s.lidar_min_range,
                              s.lidar_max_range, s.downsample_rate)
    assert float((plain.xyz[mask] - got.xyz[mask]).abs().max()) > 0.05
