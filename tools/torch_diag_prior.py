#!/usr/bin/env python3
"""The PyTorch port's ground-prior chain, gate by gate, over a simulated run.

The counterpart of tools/diag_prior.py, with its sim, flags and counts:

    python tools/torch_diag_prior.py [--scans 200] [--cols 512] [--period 24] [--seed 0]
        [--roughness 1.0]

Runs the SLAM loop over a 32-beam sim with the sim's terrain as the
external ground map, in `runtime/slam.py`'s tick order: the scan's
projection (deskewed from the ESKF as `SlamSystem` does), features and
`scan_step`, the ESKF measurement, `backend_step` at the mapping cadence,
`loop_closure_step` at its 1 Hz tick, the prior chain at its 5 Hz tick, and
`solve_graph_host` when a loop or prior tick ran since the last solve, at
most every `graph_solve_check_interval` (the runtime's scheduler defers
these to a later scan; here they run inline). At each prior tick the chain
of `runtime/cycles.prior_cycle` runs un-fused, through the same functions
in the same order (`fusion.predict_future` / `fused_pose`,
`association.compute_prior`, `backend.record_prior_observation`,
`ground.extract_patch`, `backend.prior_step`), and every gate is read on the
way: the filter's validity, the contact solver's success (and, when it
fails, which of its convergence, roll / pitch and wheel gates failed), the
record gates (more than 10 keyframes, within 10 ms of the latest
keyframe's stamp, `synced_interval` after the last prior), and the
association gates (an eligible queue entry within `near_prior_radius`, the
patch ICP's convergence and fitness, the factor's acceptance).

Two funnels of counts, each count among the ticks that passed every gate
before it: `record` (ticks, fusion_valid, solver_success, gate_count10,
gate_sync10ms, recorded) and `associate` (ticks, assoc_eligible,
assoc_accepted; every accepted association adds one prior factor). Prints
the last 40 ticks' rows and then the totals as JSON lines, beside the
card's nvidia-smi name and power limit. Writes no file. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

RECORD_FUNNEL = ("ticks", "fusion_valid", "solver_success", "gate_count10", "gate_sync10ms",
                 "recorded")
ASSOCIATE_FUNNEL = ("ticks", "assoc_eligible", "assoc_accepted")
SOLVER_FAILURES = ("fail_conv", "fail_rp", "fail_wheel")


def sim_config(n_scans: int = 200, cols: int = 512, period: float = 24.0, seed: int = 0,
               roughness: float = 1.0):
    """diag_prior.py:51-52."""
    from rolo_tpu_torch.sim import SimConfig

    return SimConfig(n_scans=n_scans, n_cols=cols, sensor="velodyne32", period=period,
                     seed=seed, roughness=roughness)


def unfused_prior_cycle(fus, stamp: float, state, gm, vehicle, cfg, stats, row):
    """`runtime/cycles.prior_cycle` step by step: the same calls in the same
    order, so the same (state, matched), with each gate counted in `stats`
    and logged in `row`."""
    from rolo_tpu_torch.filter import fusion
    from rolo_tpu_torch.geometry import so3
    from rolo_tpu_torch.geometry.se3 import SE3
    from rolo_tpu_torch.loop.closure import icp_point2point
    from rolo_tpu_torch.mapping import backend
    from rolo_tpu_torch.pointcloud.cloud import PaddedCloud
    from rolo_tpu_torch.prior import association, ground
    from rolo_tpu_torch.prior.vehicle import solve_pose

    pc = cfg.prior
    stats["ticks"] += 1
    fut = fusion.predict_future(fus, cfg.filter)
    fused = fusion.fused_pose(fus, stamp, cfg.filter)
    world_pos = fused.rot @ fut.final_pos + fused.trans
    world_rot = fused.rot @ so3.quat_to_matrix(fut.final_quat)
    yaw = torch.atan2(world_rot[1, 0], world_rot[0, 0])
    obs = association.compute_prior(gm, vehicle, world_pos[0], world_pos[1], yaw, pc, 2048)
    valid = bool(fut.valid & fused.valid)
    row.update(t=float(stamp), fusion_valid=valid, solver_success=bool(obs.success))
    if not row["solver_success"]:
        res = solve_pose(gm, vehicle, world_pos[0], world_pos[1], yaw, pc)
        row.update(solver_conv=bool(res.converged), solver_z=round(float(res.z), 2),
                   solver_rp=(round(float(res.roll), 3), round(float(res.pitch), 3)),
                   solver_wheel_max=round(float(res.wheel_signed_distances.abs().max()), 3))
        for gate, ok in zip(SOLVER_FAILURES, (
                res.converged,
                (res.roll.abs() <= pc.tolerance_roll) & (res.pitch.abs() <= pc.tolerance_pitch),
                (res.wheel_signed_distances.abs() <= pc.tolerance_wheel_distance).all())):
            stats[gate] += not bool(ok)
    db, q = state.db, state.prior_queue
    count = int(db.count)
    cur = max(count - 1, 0)
    dt_kf = abs(float(stamp) - float(db.time[cur]))
    row.update(db_count=count, gate_count10=count > 10, dt_keyframe_ms=round(dt_kf * 1e3, 2),
               gate_sync10ms=dt_kf < 1e-2,
               gate_interval=float(stamp) - float(q.last_time) >= pc.synced_interval)
    passed = True
    for gate in RECORD_FUNNEL[1:-1]:
        passed = passed and row[gate]
        stats[gate] += passed
    stats["recorded"] += passed and row["gate_interval"]

    obs = obs._replace(success=obs.success & fut.valid & fused.valid)
    n_queue = int(q.count)
    state = backend.record_prior_observation(state, obs, obs_time=stamp, cfg=cfg)
    row["pushed"] = int(state.prior_queue.count) > n_queue
    patch = ground.extract_patch(gm, state.xyz[:2], 4.0 * pc.ground_patch_size, 4096)

    # the association gates of backend.prior_step on the state it reads
    q, db = state.prior_queue, state.db
    row["queue_count"] = int(q.count)
    cur_t = torch.clamp(db.count - 1, min=0)
    live = q.valid & (torch.arange(q.capacity, device=q.count.device) < q.count)
    linked_all = torch.clamp(q.linked_key.long(), max=db.capacity - 1)
    prior_xy = ((db.rot[linked_all] @ q.rel_trans[..., None])[..., 0]
                + db.trans[linked_all])[:, :2]
    d2 = torch.sum((prior_xy - db.trans[cur_t][:2]) ** 2, dim=-1)
    eligible = live & (q.linked_key != cur_t) & (d2 < pc.near_prior_radius ** 2) & (db.count > 0)
    row["min_dist_m"] = (round(float(d2[live].min().sqrt()), 3) if bool(live.any()) else None)
    row["n_eligible"] = int(eligible.sum())
    if row["n_eligible"]:
        stats["assoc_eligible"] += 1
        pick = int(torch.argmin(torch.where(eligible, d2, float("inf"))))
        linked = int(linked_all[pick])
        entry = PaddedCloud(q.patch_xyz[pick], q.patch_mask[pick])
        factor = association.associate_prior(
            q.rel_rot[pick], q.rel_trans[pick], q.linked_key[pick], entry, True,
            db.rot[linked], db.trans[linked], cur_t, db.rot[cur_t], db.trans[cur_t], patch, pc,
            approx_knn=cfg.mapping.approx_knn)
        icp = icp_point2point(entry, patch, torch.eye(3, device=patch.xyz.device),
                              torch.zeros(3, device=patch.xyz.device),
                              max_corr_dist=pc.ground_patch_size, max_iterations=100,
                              approx_knn=cfg.mapping.approx_knn)
        # the consistency gate: odometry against the ICP-corrected prior
        # motion since the linked keyframe (z, roll, pitch)
        lk = SE3(db.rot[linked], db.trans[linked])
        odom_rel = lk.inverse().compose(SE3(db.rot[cur_t], db.trans[cur_t]))
        prior_rel = lk.inverse().compose(SE3(icp.rot, icp.trans)).compose(lk).compose(
            SE3(q.rel_rot[pick], q.rel_trans[pick]))
        o_rpy, p_rpy = so3.matrix_to_rpy(odom_rel.rot), so3.matrix_to_rpy(prior_rel.rot)
        row.update(assoc_accepted=bool(factor.accepted), icp_converged=bool(icp.converged),
                   icp_fitness=float(icp.fitness),
                   dz_m=float((odom_rel.trans[2] - prior_rel.trans[2]).abs()),
                   droll_rad=abs(math.remainder(float(o_rpy[0] - p_rpy[0]), 2 * math.pi)),
                   dpitch_rad=abs(math.remainder(float(o_rpy[1] - p_rpy[1]), 2 * math.pi)))
        stats["assoc_accepted"] += row["assoc_accepted"]
    state, matched = backend.prior_step(state, patch, cfg)
    row["matched"] = bool(matched)
    return state, matched


def _writable(state):
    """The state with fresh copies of the stores a prior cycle writes."""
    def clone(nt):
        return type(nt)(*(t.clone() for t in nt))

    return state._replace(graph=state.graph._replace(priors=clone(state.graph.priors)),
                          prior_queue=clone(state.prior_queue))


def run(frames, cfg, device, ground_points, check: bool = False, log=None) -> dict:
    """The loop over `frames` (the module docstring), the prior chain
    un-fused at each tick. With `check`, each tick also runs
    `cycles.prior_cycle` on a copy of the pre-tick state and raises unless
    it pushes, matches and counts as the un-fused chain did."""
    from rolo_tpu_torch.filter import fusion
    from rolo_tpu_torch.frontend import odometry
    from rolo_tpu_torch.mapping import backend
    from rolo_tpu_torch.pointcloud.cloud import PaddedCloud, concat_clouds
    from rolo_tpu_torch.pointcloud.features import extract_features
    from rolo_tpu_torch.pointcloud.projection import RawScan, project_scan
    from rolo_tpu_torch.prior.vehicle import from_config as vehicle_from_config
    from rolo_tpu_torch.runtime.cycles import prior_cycle
    from rolo_tpu_torch.runtime.slam import deskew_increment, ground_map_from_points

    device = torch.device(device)
    st, s, reg, lc = cfg.static, cfg.sensor, cfg.registration, cfg.loop
    front = odometry.init_state(st.max_feature_points, device)
    state = backend.init_backend(cfg, device)
    fus = fusion.init_fusion(cfg.filter, device)
    vehicle = vehicle_from_config(cfg.prior, device)
    gm = ground_map_from_points(ground_points, device)
    stats, ticks = collections.Counter(), []
    last_map = last_loop = last_prior = -float("inf")
    last_stamp, dirty, next_solve, mapping_steps = None, False, 0.0, 0
    epoch = frames[0].stamp
    t0 = time.perf_counter()
    for n, frame in enumerate(frames, 1):
        stamp = float(frame.stamp - epoch)
        interval = s.scan_period if last_stamp is None else max(stamp - last_stamp, 1e-3)
        last_stamp = stamp
        cap = st.max_raw_points
        m = min(frame.points.shape[0], cap)
        xyz = torch.zeros(cap, 3, device=device)
        ring = torch.zeros(cap, dtype=torch.int32, device=device)
        rel = torch.zeros(cap, device=device)
        xyz[:m], ring[:m], rel[:m] = frame.points[:m, :3], frame.ring[:m], frame.rel_time[:m]
        scan = RawScan(xyz, ring, rel, torch.arange(cap, device=device) < m)
        interval_t = torch.full((), interval, device=device)
        deskew = {}
        if s.deskew_enabled:
            rpy, vel = deskew_increment(fus, front, interval)
            deskew = dict(deskew_rpy=rpy, odom_time_diff=interval_t, deskew_vel=vel)
        img = project_scan(scan, s.n_scan, s.horizon_scan, s.lidar_min_range, s.lidar_max_range,
                           s.downsample_rate, **deskew)
        fc = extract_features(img, cfg.features.edge_threshold, cfg.features.surf_threshold,
                              cfg.features.odometry_surf_leaf_size, st.max_corner_points,
                              st.max_surf_points)
        feat = concat_clouds(fc.corners, fc.surfaces, st.max_feature_points)
        front, fo = odometry.scan_step(front, feat.xyz, feat.mask, interval_t, reg, st.max_voxels,
                                       reg.k_correspondences,
                                       enable_failure_gate=reg.enable_failure_gate)
        fus, _ = fusion.on_front_odometry(fus, stamp, fo.pose_rot, fo.pose_trans, cfg.filter)
        if stamp - last_map >= cfg.mapping.mapping_process_interval:
            last_map = stamp
            raw = PaddedCloud(img.xyz.reshape(-1, 3), img.mask.reshape(-1))
            sc_cloud = raw if lc.sc_input_type == "scan_raw" else fc.surfaces
            state, out = backend.backend_step(state, fc.corners, fc.surfaces, sc_cloud,
                                              fo.pose_rot, fo.pose_trans, True, stamp, cfg)
            fus = fusion.on_mapping_odometry(fus, out.rot, out.trans, fo.pose_rot, fo.pose_trans)
            mapping_steps += 1
        if lc.enable and stamp - last_loop >= 1.0 / lc.frequency_hz:
            last_loop = stamp
            state, _ = backend.loop_closure_step(state, cfg)
            dirty = True
        if cfg.prior.enable and stamp - last_prior >= 1.0 / cfg.prior.frequency_hz:
            last_prior = stamp
            want = None
            if check:
                ref_state, ref_matched = prior_cycle(fus, stamp, _writable(state), gm, vehicle,
                                                     cfg)
                want = (int(ref_state.prior_queue.count), int(ref_state.graph.priors.count),
                        bool(ref_matched))
            row = {}
            state, matched = unfused_prior_cycle(fus, stamp, state, gm, vehicle, cfg, stats, row)
            got = (int(state.prior_queue.count), int(state.graph.priors.count), bool(matched))
            if want is not None and got != want:
                raise AssertionError(f"tick at {stamp:.2f} s: the un-fused chain gave (queue, "
                                     f"priors, matched) {got}, prior_cycle {want}")
            ticks.append(row)
            dirty = True
        if dirty and mapping_steps >= 1 and stamp >= next_solve:
            next_solve = stamp + cfg.mapping.graph_solve_check_interval
            dirty = False
            state = backend.solve_graph_host(state, cfg, count_hint=mapping_steps + 1)
        if log is not None and n % 50 == 0:
            log(f"scan {n} ({time.perf_counter() - t0:.0f} s) stats={dict(stats)}")
    return {"ticks": ticks,
            "funnel": {"record": {k: stats[k] for k in RECORD_FUNNEL},
                       "associate": {k: stats[k] for k in ASSOCIATE_FUNNEL}},
            "solver_failures": {k: stats[k] for k in SOLVER_FAILURES},
            "n_prior_factors": int(state.graph.priors.count),
            "queue_count": int(state.prior_queue.count),
            "n_keyframes": int(state.db.count), "n_scans": len(frames),
            "wall_s": time.perf_counter() - t0}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scans", type=int, default=200)
    ap.add_argument("--cols", type=int, default=512)
    ap.add_argument("--period", type=float, default=24.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--roughness", type=float, default=1.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("torch_diag_prior.py needs a CUDA device")
    from rolo_tpu_torch.config import RoloConfig
    from rolo_tpu_torch.runtime.platform import bench_metadata, configure_precision
    from rolo_tpu_torch.sim.dataset import generate_sequence, ground_map_points, make_scene

    configure_precision()
    device = torch.device("cuda")
    sim = sim_config(args.scans, args.cols, args.period, args.seed, args.roughness)
    scene = make_scene(sim, device)
    report = run(list(generate_sequence(sim, device, scene)), RoloConfig(), device,
                 ground_map_points(sim, device, scene),
                 log=lambda line: print(line, file=sys.stderr, flush=True))
    for row in report.pop("ticks")[-40:]:
        print(json.dumps(row))
    print(json.dumps({**report, "machine": bench_metadata()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
