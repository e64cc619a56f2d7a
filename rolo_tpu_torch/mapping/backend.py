"""The back-end mapping step and the bucketed pose-graph solve, torch port
of `rolo_tpu/mapping/backend.py` (backMapping's laserCloudInfoHandler and
correctPoses).

`backend_step(state, ...) -> (state, output)` runs at the mapping cadence:
initial guess from the front-end increment, submap extraction, scan-to-submap
GN, keyframe gating, the odometry factor and the scan-context descriptor.
`solve_graph_host` re-solves the pose graph at the smallest capacity bucket
that covers the keyframes. The keyframe DB (~0.44 GB at `RoloConfig()`
capacities), the descriptor store and the odometry factors are written one
row at a time in place, so a step's state shares its stores with the state
it came from. The reference's `lax.cond(db.count > 0, optimize, skip)` is one
host branch per step. Loop closure, priors and their steps belong to later
slices; the state carries their stores all the same, so a state moves
between the two packages with `backend_state_from_numpy` /
`backend_state_to_numpy`.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Tuple

import numpy as np
import torch

from ..config import RoloConfig
from ..geometry import so3
from ..geometry.se3 import SE3
from ..graph.factors import BetweenFactors, PoseGraph, empty_graph
from ..graph.solver import solve_pose_graph
from ..loop import scancontext as sc
from ..ops.rows import write_row_
from ..pointcloud.cloud import PaddedCloud
from ..pointcloud.features import voxel_downsample
from ..prior.association import PriorQueue, init_queue
from .keyframes import (KeyframeDB, add_keyframe, extract_submap, init_db, latest_pose,
                        should_add_keyframe)
from .scan2map import constrain_transform, scan2map_optimize

_PRIOR_PATCH_CAPACITY = 2048  # backend.py:89


class BackendState(NamedTuple):
    db: KeyframeDB
    graph: PoseGraph
    scdb: sc.ScanContextDB
    prior_queue: PriorQueue
    loop_matched: torch.Tensor  # [K] bool
    rpy: torch.Tensor  # [3] transformTobeMapped[0:3]
    xyz: torch.Tensor  # [3] transformTobeMapped[3:6]
    last_front_rot: torch.Tensor  # [3, 3]
    last_front_trans: torch.Tensor  # [3]
    has_front: torch.Tensor  # [] bool
    pending_solve: torch.Tensor  # [] bool
    # events dropped because a store was full: (keyframes, loop factors,
    # prior factors, prior queue overwrites)
    dropped_counts: torch.Tensor  # [4] int32


class BackendOutput(NamedTuple):
    rot: torch.Tensor  # [3, 3] mapping pose
    trans: torch.Tensor  # [3]
    keyframe_added: torch.Tensor  # [] bool
    degenerate: torch.Tensor  # [] bool
    s2m_iterations: torch.Tensor
    num_factors: torch.Tensor
    keyframe_dropped: torch.Tensor  # [] bool: gated in, but the DB was full
    solve_due: torch.Tensor  # [] bool: pending_solve & keyframe_added


def init_backend(cfg: RoloConfig, device=None, dtype=torch.float32) -> BackendState:
    st = cfg.static
    return BackendState(
        db=init_db(st.max_keyframes, st.max_corner_points, st.max_surf_points, device, dtype),
        graph=empty_graph(st.max_keyframes, st.max_loop_factors, st.max_prior_factors, device,
                          dtype),
        scdb=sc.init_db(st.max_keyframes, cfg.loop.sc_num_ring, cfg.loop.sc_num_sector, device,
                        dtype),
        prior_queue=init_queue(st.max_prior_factors, _PRIOR_PATCH_CAPACITY, device, dtype),
        loop_matched=torch.zeros(st.max_keyframes, dtype=torch.bool, device=device),
        rpy=torch.zeros(3, dtype=dtype, device=device),
        xyz=torch.zeros(3, dtype=dtype, device=device),
        last_front_rot=torch.eye(3, dtype=dtype, device=device),
        last_front_trans=torch.zeros(3, dtype=dtype, device=device),
        has_front=torch.tensor(False, device=device),
        pending_solve=torch.tensor(False, device=device),
        dropped_counts=torch.zeros(4, dtype=torch.int32, device=device),
    )


def _rpy_pose(rpy: torch.Tensor, xyz: torch.Tensor) -> SE3:
    return SE3(so3.rpy_to_matrix(rpy[0], rpy[1], rpy[2]), xyz)


def _rpy_of(rot: torch.Tensor) -> torch.Tensor:
    return torch.stack(so3.matrix_to_rpy(rot))


def _update_initial_guess(state: BackendState, front_rot, front_trans, odom_available):
    """updateInitialGuess (backend.py:101-113): the front-end increment since
    the last step composed onto the current mapped pose."""
    cur = _rpy_pose(state.rpy, state.xyz)
    incre = SE3(state.last_front_rot, state.last_front_trans).inverse().compose(
        SE3(front_rot, front_trans))
    guessed = cur.compose(incre)
    use = odom_available & state.has_front & (state.db.count > 0)
    rot = torch.where(use, guessed.rot, cur.rot)
    trans = torch.where(use, guessed.trans, cur.trans)
    return _rpy_of(rot), trans


def backend_step(state: BackendState, corner: PaddedCloud, surf: PaddedCloud,
                 sc_cloud: PaddedCloud, front_rot: torch.Tensor, front_trans: torch.Tensor,
                 odom_available, scan_time, cfg: RoloConfig
                 ) -> Tuple[BackendState, BackendOutput]:
    """One mapping step (backend.py:116-246). corner / surf: this scan's
    feature clouds in the sensor frame; sc_cloud: the cloud scan-context
    reads; front_rot / front_trans: the front-end pose."""
    st, m = cfg.static, cfg.mapping
    dev = state.xyz.device
    odom_available = torch.as_tensor(odom_available, device=dev)
    scan_time = torch.as_tensor(scan_time, dtype=state.xyz.dtype, device=dev)
    rpy, xyz = _update_initial_guess(state, front_rot, front_trans, odom_available)

    corner_ds = voxel_downsample(corner, m.mapping_corner_leaf_size, st.max_corner_points)
    surf_ds = voxel_downsample(surf, m.mapping_surf_leaf_size, st.max_surf_points)

    if bool(state.db.count > 0):
        sub_c, sub_s = extract_submap(
            state.db, xyz, scan_time, m.surrounding_keyframe_search_radius,
            m.surrounding_keyframe_recency_sec, max_nearby=m.surrounding_keyframe_max_nearby,
            corner_out_cap=st.max_submap_points, surf_out_cap=st.max_submap_points,
            corner_leaf=m.mapping_corner_leaf_size, surf_leaf=m.mapping_surf_leaf_size)
        res = scan2map_optimize(
            rpy, xyz, corner_ds.xyz, corner_ds.mask, surf_ds.xyz, surf_ds.mask, sub_c, sub_s,
            max_iterations=m.scan2map_max_iterations,
            degeneracy_threshold=m.degeneracy_eigen_threshold, chunk=st.knn_query_chunk,
            rebind_every=m.scan2map_rebind_every, approx_knn=m.approx_knn,
            n_candidates=m.scan2map_candidates)
        rpy, xyz, degen, iters, nfac = (res.rpy, res.trans, res.degenerate, res.iterations,
                                        res.num_factors)
    else:
        degen = torch.tensor(False, device=dev)
        iters = nfac = torch.tensor(0, dtype=torch.int32, device=dev)
    rpy, xyz = constrain_transform(rpy, xyz, m.rotation_tolerance, m.z_tolerance)
    pose = _rpy_pose(rpy, xyz)

    # saveKeyFramesAndFactor: the odometry factor (or the first-pose prior)
    # and the descriptor are computed against the DB before the append
    add = should_add_keyframe(state.db, pose, m.surrounding_keyframe_adding_dist_threshold,
                              m.surrounding_keyframe_adding_angle_threshold)
    count = state.db.count
    is_first = count == 0
    rel = latest_pose(state.db).inverse().compose(pose)
    graph = state.graph
    odom_idx = torch.clamp(count, max=st.max_keyframes - 1)
    write_row_(graph.odom_rel_rot, odom_idx, rel.rot, add & ~is_first)
    write_row_(graph.odom_rel_trans, odom_idx, rel.trans, add & ~is_first)
    graph = graph._replace(first_rot=torch.where(add & is_first, pose.rot, graph.first_rot),
                           first_trans=torch.where(add & is_first, pose.trans, graph.first_trans))
    desc = sc.make_descriptor(sc_cloud.xyz, sc_cloud.mask, cfg.loop.sc_num_ring,
                              cfg.loop.sc_num_sector, cfg.loop.sc_max_radius,
                              cfg.loop.sc_lidar_height)
    scdb = sc.add_descriptor(state.scdb, desc, enable=add)
    db = add_keyframe(state.db, pose, scan_time, corner_ds, surf_ds, enable=add)

    dropped = add & (count >= st.max_keyframes)
    new_state = state._replace(
        db=db, graph=graph, scdb=scdb, rpy=_rpy_of(pose.rot), xyz=pose.trans,
        last_front_rot=front_rot, last_front_trans=front_trans,
        has_front=state.has_front | odom_available,
        dropped_counts=state.dropped_counts + torch.nn.functional.pad(
            dropped.to(torch.int32)[None], (0, 3)))
    return new_state, BackendOutput(
        rot=pose.rot, trans=pose.trans, keyframe_added=add & ~dropped, degenerate=degen,
        s2m_iterations=iters, num_factors=nfac, keyframe_dropped=dropped,
        solve_due=state.pending_solve & add)


# The solve compiles per bucket in the reference; here the bucket bounds the
# work: a run with k keyframes solves over the smallest bucket >= k.
_SOLVE_BUCKETS = (64, 128, 256, 512, 1024, 2048)


def _apply_solution(state: BackendState, sol_rot, sol_trans) -> BackendState:
    """Write a bucket's solved poses into the DB and move the current pose
    by the latest keyframe's correction `solved o old^-1` (backend.py:
    256-289), so a no-op solve leaves the current pose unchanged."""
    b = sol_rot.shape[0]
    db = state.db
    old_latest = latest_pose(db)
    valid = (torch.arange(b, device=sol_rot.device) < db.count)
    db.rot[:b] = torch.where(valid[:, None, None], sol_rot, db.rot[:b])
    db.trans[:b] = torch.where(valid[:, None], sol_trans, db.trans[:b])
    delta = latest_pose(db).compose(old_latest.inverse())
    cur = delta.compose(_rpy_pose(state.rpy, state.xyz))
    return state._replace(db=db, rpy=_rpy_of(cur.rot), xyz=cur.trans,
                          pending_solve=torch.zeros_like(state.pending_solve))


def solve_graph_host(state: BackendState, cfg: RoloConfig = None,
                     count_hint: int = None) -> BackendState:
    """Pose-graph solve + correctPoses at the smallest capacity bucket that
    covers the keyframes (backend.py:292-327), with method="bcr".
    `count_hint`: a host-known upper bound on the keyframe count (such as
    the number of mapping steps driven); with it the bucket is chosen
    without reading the device. A too-large hint only costs a larger bucket:
    the solver masks by the device-side count."""
    del cfg  # kept for the reference's signature
    count = int(state.db.count) if count_hint is None else int(count_hint)
    if count < 1:
        return state._replace(pending_solve=torch.zeros_like(state.pending_solve))
    cap = state.db.capacity
    bucket = next((b for b in _SOLVE_BUCKETS if count <= b <= cap), cap)
    g = state.graph
    g_b = g._replace(odom_rel_rot=g.odom_rel_rot[:bucket], odom_rel_trans=g.odom_rel_trans[:bucket])
    sol = solve_pose_graph(g_b, state.db.rot[:bucket], state.db.trans[:bucket], state.db.count,
                           method="bcr")
    return _apply_solution(state, sol.rot, sol.trans)


def _flat_fields(nt, prefix: str = ""):
    for name in nt._fields:
        value = getattr(nt, name)
        if hasattr(value, "_fields"):
            yield from _flat_fields(value, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", value


def backend_state_to_numpy(state) -> dict:
    """A BackendState (this package's or the JAX package's) as numpy arrays
    keyed by field path, nested NamedTuples flattened: "db.rot",
    "graph.loops.i", "rpy", ..."""
    out = {}
    for key, value in _flat_fields(state):
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu()
        out[key] = np.asarray(value)
    return out


def backend_state_from_numpy(arrays: Mapping, device) -> BackendState:
    """A BackendState on `device` from `backend_state_to_numpy`'s layout,
    with the same shapes and dtypes (writable copies)."""

    def build(cls, prefix):
        fields = {}
        for name in cls._fields:
            sub = _NESTED.get((cls, name))
            key = f"{prefix}{name}"
            fields[name] = (build(sub, key + ".") if sub is not None
                            else torch.tensor(np.array(arrays[key]), device=device))
        return cls(**fields)

    return build(BackendState, "")


_NESTED = {(BackendState, "db"): KeyframeDB, (BackendState, "graph"): PoseGraph,
           (BackendState, "scdb"): sc.ScanContextDB, (BackendState, "prior_queue"): PriorQueue,
           (PoseGraph, "loops"): BetweenFactors, (PoseGraph, "priors"): BetweenFactors}
