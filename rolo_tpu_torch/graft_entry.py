"""Entry points of the port: a one-device forward step and a dry run over a
process group, the counterparts of `__graft_entry__.py`'s `entry()` and
`dryrun_multichip(n)`.

    python -m rolo_tpu_torch.graft_entry        # entry() on the card

`dryrun_multichip(n)` runs on the group it finds (one rank of a one-rank
group when none exists): every process of an n-rank group calls it after
`parallel.mesh.distributed_init`. Each of its three phases checks the
recovered poses against the known motion, and reduces the worst error over
the group, so every rank raises together.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .config import (LoopConfig, MappingConfig, RegistrationConfig, RoloConfig,
                     StaticConfig)
from .runtime.platform import configure_precision, default_device


def _synthetic_features(n, seed=0):
    """Four noisy walls (__graft_entry__.py:14-27)."""
    rng = np.random.default_rng(seed)
    pts = []
    for normal, d in [((1, 0, 0), 8.0), ((0, 1, 0), 10.0), ((0.6, 0.8, 0), 12.0),
                      ((0, -1, 0), 9.0)]:
        m = n // 4
        u = rng.uniform(-6, 6, (m, 2))
        nv = np.array(normal, np.float64)
        nv /= np.linalg.norm(nv)
        t1 = np.cross(nv, [0, 0, 1.0])
        t1 /= np.linalg.norm(t1)
        t2 = np.cross(nv, t1)
        pts.append(d * nv + u[:, :1] * t1 + u[:, 1:] * t2)
    pts = np.concatenate(pts)[:n].astype(np.float32)
    pts += rng.normal(0, 0.01, pts.shape).astype(np.float32)
    return pts


def entry(device=None):
    """(fn, example_args): one front-end scan_step at 4,096 points against a
    previous scan, on the card unless `device` says otherwise."""
    from .frontend.odometry import init_state, scan_step

    device = default_device() if device is None else torch.device(device)
    configure_precision()
    n = 4096
    cfg = RegistrationConfig()
    state = init_state(n, device)._replace(
        prev_xyz=torch.tensor(_synthetic_features(n), device=device),
        prev_mask=torch.ones(n, dtype=torch.bool, device=device),
        initialized=torch.tensor(True, device=device))
    new_xyz = torch.tensor(_synthetic_features(n, seed=1), device=device)
    new_mask = torch.ones(n, dtype=torch.bool, device=device)
    interval = torch.tensor(0.1, device=device)

    def fn(state, new_xyz, new_mask, interval):
        return scan_step(state, new_xyz, new_mask, interval, cfg, 8192, 20)

    return fn, (state, new_xyz, new_mask, interval)


def _rot_z(angle):
    c, s = np.cos(angle), np.sin(angle)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)


def _rot_err_deg(gt_rot, rot) -> np.ndarray:
    cos = np.clip((np.trace(np.einsum("bij,bik->bjk", gt_rot, rot), axis1=1, axis2=2) - 1) / 2,
                  -1, 1)
    return np.degrees(np.arccos(cos))


def _group_max(values, device) -> np.ndarray:
    """Elementwise max of each rank's values over the group."""
    t = torch.tensor(np.asarray(values, np.float64), device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.cpu().numpy()


def dryrun_multichip(n_devices: int, device=None) -> None:
    """Three pose-checked phases over an n_devices-rank group
    (__graft_entry__.py:59-251): data-parallel registration of n_devices
    pairs, each rank its slice, with the mean error all-reduced; one
    registration with its points split over the ranks; and batched mapping,
    one backend_step call per step over the rank's sequences, then one dense
    graph solve over their graphs. Raises on a pose outside the reference's
    limits."""
    from .graph.solver import solve_pose_graph
    from .mapping import backend as mb
    from .parallel.batch import group_mean, registration_batch, shard_registration_inputs
    from .parallel.mesh import make_mesh, shard_batch
    from .parallel.spmd import register_scan_pair_spmd
    from .pointcloud.cloud import PaddedCloud

    device = default_device() if device is None else torch.device(device)
    configure_precision()
    mesh = make_mesh(n_devices, device_type=device.type)
    lead = dist.get_rank() == 0

    def say(msg):
        if lead:
            print(f"dryrun_multichip({n_devices}): {msg}", flush=True)

    # Phase 1: data parallelism over scan pairs, each with a known motion
    b, n = n_devices, 256
    cfg = RegistrationConfig()
    rng = np.random.default_rng(42)
    src = np.stack([_synthetic_features(n, seed=i) for i in range(b)])
    gt_rot = np.stack([_rot_z(0.02 + 0.005 * i) for i in range(b)])
    gt_trans = np.stack([np.array([0.2 + 0.02 * i, -0.1, 0.05], np.float32) for i in range(b)])
    tgt = np.einsum("bij,bnj->bni", gt_rot, src) + gt_trans[:, None, :]
    tgt = (tgt + rng.normal(0, 0.005, tgt.shape)).astype(np.float32)
    mask = torch.ones(b, n, dtype=torch.bool, device=device)
    inputs = shard_registration_inputs(mesh, torch.tensor(src, device=device), mask,
                                       torch.tensor(tgt, device=device), mask)
    res = registration_batch(*inputs, cfg=cfg, voxel_capacity=512, k=10)
    mean_err = group_mean(res.rot_error)
    my_rot, my_trans = (t.numpy() for t in shard_batch((torch.tensor(gt_rot),
                                                        torch.tensor(gt_trans)), mesh))
    rot_err = _rot_err_deg(my_rot, res.rot.cpu().numpy())
    trans_err = np.linalg.norm(res.trans.cpu().numpy() - my_trans, axis=1)
    worst = _group_max([rot_err.max(), trans_err.max()], device)
    if not bool(torch.isfinite(mean_err)):
        raise AssertionError(f"dp mean rotation error is not finite: {mean_err}")
    say(f"dp rot_err_deg max={worst[0]:.3f} trans_err max={worst[1]:.3f} m")
    if not worst[0] < 2.0:
        raise AssertionError(f"dp rotation off: {worst[0]:.3f} deg")
    if not worst[1] < 0.10:
        raise AssertionError(f"dp translation off: {worst[1]:.3f} m")
    say("dp ok (pose-checked)")

    # Phase 2: one registration with its points split over the ranks, the
    # Hessians, gradients and errors all-reduced every LM iteration
    n_sp = max(256, n_devices * 64)
    sp_src = _synthetic_features(n_sp, seed=3)
    sp_gt_rot = _rot_z(0.03)
    sp_gt_trans = np.array([0.2, -0.05, 0.02], np.float32)
    sp_tgt = (sp_src @ sp_gt_rot.T + sp_gt_trans).astype(np.float32)
    sp_mask = torch.ones(n_sp, dtype=torch.bool, device=device)
    zero = torch.zeros(3, device=device)
    dt = torch.tensor(0.1, device=device)
    point_mesh = make_mesh(n_devices, axis_names=("point",), device_type=device.type)
    res = register_scan_pair_spmd(point_mesh, torch.tensor(sp_src, device=device), sp_mask,
                                  torch.tensor(sp_tgt, device=device), sp_mask, zero, zero, dt, dt,
                                  cfg, 512, 10)
    sp_rot_err = float(_rot_err_deg(sp_gt_rot[None], res.rot.cpu().numpy()[None])[0])
    sp_trans_err = float(np.linalg.norm(res.trans.cpu().numpy() - sp_gt_trans))
    say(f"spmd rot_err_deg={sp_rot_err:.3f} trans_err={sp_trans_err:.3f} m")
    if not sp_rot_err < 2.0:
        raise AssertionError(f"spmd rotation off: {sp_rot_err:.3f} deg")
    if not sp_trans_err < 0.10:
        raise AssertionError(f"spmd translation off: {sp_trans_err:.3f} m")
    say("spmd ok (pose-checked)")

    # Phase 3: mapping over n_devices sequences (sequence i advances
    # 0.8 + 0.05 i m a step along x), each rank stepping its own as one
    # batch, then one batched dense pose-graph solve
    mcfg = RoloConfig(
        mapping=MappingConfig(scan2map_max_iterations=4), loop=LoopConfig(enable=False),
        static=StaticConfig(max_raw_points=2048, max_corner_points=128, max_surf_points=256,
                            max_feature_points=384, max_voxels=512, max_keyframes=8,
                            max_submap_points=1024, max_loop_factors=4, max_prior_factors=4,
                            knn_query_chunk=128))
    mst = mcfg.static
    km = 3
    seqs = shard_batch(torch.arange(n_devices), mesh).tolist()

    def pillar_scan(trans, seed):
        prng = np.random.default_rng(seed)
        pts = []
        for px, py in [(4.0, 2.0), (6.0, -3.0), (9.0, 1.0), (3.0, -1.5)]:
            z = prng.uniform(-1.0, 2.0, (32, 1))
            pts.append(np.concatenate([np.full((32, 1), px), np.full((32, 1), py), z], axis=1))
        c = np.concatenate(pts).astype(np.float32)
        c += prng.normal(0, 0.005, c.shape).astype(np.float32)
        return c - trans

    gt_m = np.zeros((n_devices, km, 3), np.float32)
    for bi in range(n_devices):
        gt_m[bi, :, 0] = (0.8 + 0.05 * bi) * np.arange(km)
    states = mb.init_backend(mcfg, device, batch=len(seqs))
    eye = torch.eye(3, device=device).expand(len(seqs), 3, 3)

    def clouds(points, capacity):
        one = [PaddedCloud.from_points(p, capacity, device) for p in points]
        return PaddedCloud(torch.stack([c.xyz for c in one]), torch.stack([c.mask for c in one]))

    for si in range(km):
        noise = np.random.default_rng(si).normal(0, 0.02, (n_devices, 3)).astype(np.float32)
        corner = clouds([pillar_scan(gt_m[bi, si], seed=100 + bi) for bi in seqs],
                        mst.max_corner_points)
        surf = clouds([_synthetic_features(mst.max_surf_points, seed=200 + bi) - gt_m[bi, si]
                       for bi in seqs], mst.max_surf_points)
        guess = gt_m[seqs, si] + (noise[seqs] if si else 0.0)
        states, _ = mb.backend_step(states, corner, surf, surf, eye,
                                    torch.tensor(guess, device=device), True, 0.5 * si, mcfg)
    db = states.db
    bad_counts = float((db.count != km).any())
    kf = db.trans[:, :km].cpu().numpy()
    kf_err = float(np.linalg.norm(kf - gt_m[seqs], axis=2).max())
    sol = solve_pose_graph(states.graph, db.rot, db.trans, db.count, method="dense")
    strans = sol.trans[:, :km].cpu().numpy()
    solve_err = (float(np.linalg.norm(strans - kf, axis=2).max()) if np.isfinite(strans).all()
                 else float("inf"))
    bad_counts, kf_err, solve_err = _group_max([bad_counts, kf_err, solve_err], device)
    say(f"batched mapping kf_err max={kf_err:.3f} m, graph-solve drift {solve_err:.4f} m")
    if bad_counts:
        raise AssertionError(f"batched mapping added other than {km} keyframes")
    if not kf_err < 0.25:
        raise AssertionError(f"batched mapping poses off: {kf_err:.3f} m")
    if not solve_err < 0.05:
        raise AssertionError(f"graph solve drifted: {solve_err:.4f} m")
    say("batched mapping + graph solve ok (pose-checked)")


if __name__ == "__main__":
    step, args = entry()
    step(*args)
    print("entry ok")
