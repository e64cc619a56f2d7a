"""The back-end mapping step and the bucketed pose-graph solve, torch port
of `rolo_tpu/mapping/backend.py` (backMapping's laserCloudInfoHandler and
correctPoses).

`backend_step(state, ...) -> (state, output)` runs at the mapping cadence:
initial guess from the front-end increment, submap extraction, scan-to-submap
GN, keyframe gating, the odometry factor and the scan-context descriptor.
`solve_graph_host` re-solves the pose graph at the smallest capacity bucket
that covers the keyframes. `loop_closure_step` (scan-context and
radius-search detection, ICP verification, 1 Hz), `external_loop_step`,
`record_prior_observation` and `prior_step` (5 Hz) add the loop and prior
factors the solve exists for. The keyframe DB (~0.44 GB at `RoloConfig()`
capacities), the descriptor store, the factor stores, `loop_matched` and the
prior queue are written one row at a time in place, so a step's state shares
its stores with the state it came from. Each `lax.cond` of the reference is
one host branch. A state moves between the two packages with
`backend_state_from_numpy` / `backend_state_to_numpy`.

`backend_step` and `solve_graph_host` also take B sequences' states at once
(`init_backend(..., batch=B)`, or `ops.pytree.tree_stack` of B states):
the reference's offline `jax.vmap(backend_step)`. Each instance gets the bits
it gets alone; the host branch on the keyframe count becomes a per-instance
selection.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple, Tuple

import torch

from ..config import RoloConfig
from ..geometry import so3
from ..geometry.se3 import SE3
from ..graph.factors import PoseGraph, add_between, empty_graph
from ..graph.solver import solve_pose_graph
from ..loop import closure as loopmod
from ..loop import scancontext as sc
from ..ops.pytree import tree_from_numpy, tree_index, tree_stack, tree_to_numpy
from ..ops.rows import read_row, write_row_
from ..pointcloud.cloud import PaddedCloud
from ..pointcloud.features import voxel_downsample
from ..prior import association as priormod
from ..prior.association import PriorQueue, init_queue
from ..runtime import profiling
from ..runtime.platform import default_device
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


def init_backend(cfg: RoloConfig, device=None, dtype=torch.float32,
                 batch: int = None) -> BackendState:
    """A fresh state; with `batch`, B of them stacked along a leading dim
    (~0.44 GB each at `RoloConfig()` capacities)."""
    device = default_device() if device is None else device
    st = cfg.static
    state = BackendState(
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
    return state if batch is None else tree_stack([state] * batch)


def _rpy_pose(rpy: torch.Tensor, xyz: torch.Tensor) -> SE3:
    return SE3(so3.rpy_to_matrix(rpy[..., 0], rpy[..., 1], rpy[..., 2]), xyz)


def _rpy_of(rot: torch.Tensor) -> torch.Tensor:
    return torch.stack(so3.matrix_to_rpy(rot), dim=-1)


def _count_drop(counts: torch.Tensor, slot: int, dropped: torch.Tensor) -> torch.Tensor:
    """dropped_counts with `dropped` (a bool, [] or [B]) added at `slot`."""
    return counts + torch.nn.functional.pad(dropped.to(torch.int32)[..., None], (slot, 3 - slot))


def _update_initial_guess(state: BackendState, front_rot, front_trans, odom_available):
    """updateInitialGuess (backend.py:101-113): the front-end increment since
    the last step composed onto the current mapped pose."""
    cur = _rpy_pose(state.rpy, state.xyz)
    incre = SE3(state.last_front_rot, state.last_front_trans).inverse().compose(
        SE3(front_rot, front_trans))
    guessed = cur.compose(incre)
    use = odom_available & state.has_front & (state.db.count > 0)
    rot = torch.where(use[..., None, None], guessed.rot, cur.rot)
    trans = torch.where(use[..., None], guessed.trans, cur.trans)
    return _rpy_of(rot), trans


def backend_step(state: BackendState, corner: PaddedCloud, surf: PaddedCloud,
                 sc_cloud: PaddedCloud, front_rot: torch.Tensor, front_trans: torch.Tensor,
                 odom_available, scan_time, cfg: RoloConfig
                 ) -> Tuple[BackendState, BackendOutput]:
    """One mapping step (backend.py:116-246). corner / surf: this scan's
    feature clouds in the sensor frame; sc_cloud: the cloud scan-context
    reads; front_rot / front_trans: the front-end pose.

    With a state of B sequences (its fields lead with [B]) the clouds lead
    with [B], front_rot / front_trans are [B, 3, 3] / [B, 3], and
    odom_available / scan_time are scalars or [B]: one step of each
    sequence, the outputs [B]. Submap extraction and scan-to-map run when
    any instance has a keyframe, and each instance takes their result only
    if it has one."""
    if state.xyz.dim() == 1:
        one = tree_index(state, None)
        new, out = backend_step(one, *(PaddedCloud(c.xyz[None], c.mask[None])
                                       for c in (corner, surf, sc_cloud)),
                                front_rot[None], front_trans[None], odom_available, scan_time, cfg)
        return tree_index(new, 0), tree_index(out, 0)
    st, m = cfg.static, cfg.mapping
    dev, bsz = state.xyz.device, state.xyz.shape[0]
    odom_available = torch.as_tensor(odom_available, device=dev).expand(bsz)
    scan_time = torch.as_tensor(scan_time, dtype=state.xyz.dtype, device=dev).expand(bsz)
    rpy, xyz = _update_initial_guess(state, front_rot, front_trans, odom_available)

    corner_ds = voxel_downsample(corner, m.mapping_corner_leaf_size, st.max_corner_points)
    surf_ds = voxel_downsample(surf, m.mapping_surf_leaf_size, st.max_surf_points)

    has_map = state.db.count > 0
    degen = torch.zeros(bsz, dtype=torch.bool, device=dev)
    iters = nfac = torch.zeros(bsz, dtype=torch.int32, device=dev)
    if profiling.host_read(has_map.any()):
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
        rpy = torch.where(has_map[:, None], res.rpy, rpy)
        xyz = torch.where(has_map[:, None], res.trans, xyz)
        degen = res.degenerate & has_map
        iters = torch.where(has_map, res.iterations, iters)
        nfac = torch.where(has_map, res.num_factors, nfac)
        if profiling.tracing():  # the GN stopped at its cap unconverged
            profiling.count("s2m_capped", has_map & ~res.converged
                            & (res.iterations >= m.scan2map_max_iterations))
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
    first = (add & is_first)[:, None]
    graph = graph._replace(first_rot=torch.where(first[..., None], pose.rot, graph.first_rot),
                           first_trans=torch.where(first, pose.trans, graph.first_trans))
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
        dropped_counts=_count_drop(state.dropped_counts, 0, dropped))
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
    256-289), so a no-op solve leaves the current pose unchanged. A state
    without keyframes keeps its pose, as does each such instance of a
    batch."""
    b = sol_rot.shape[-3]
    db = state.db
    old_latest = latest_pose(db)
    valid = db.valid()[..., :b]
    db.rot[..., :b, :, :] = torch.where(valid[..., None, None], sol_rot, db.rot[..., :b, :, :])
    db.trans[..., :b, :] = torch.where(valid[..., None], sol_trans, db.trans[..., :b, :])
    delta = latest_pose(db).compose(old_latest.inverse())
    cur = delta.compose(_rpy_pose(state.rpy, state.xyz))
    has_kf = (db.count > 0)[..., None]
    return state._replace(db=db, rpy=torch.where(has_kf, _rpy_of(cur.rot), state.rpy),
                          xyz=torch.where(has_kf, cur.trans, state.xyz),
                          pending_solve=torch.zeros_like(state.pending_solve))


def solve_graph_host(state: BackendState, cfg: RoloConfig = None,
                     count_hint: int = None) -> BackendState:
    """Pose-graph solve + correctPoses at the smallest capacity bucket that
    covers the keyframes (backend.py:292-327), with method="bcr".
    `count_hint`: a host-known upper bound on the keyframe count (such as
    the number of mapping steps driven); with it the bucket is chosen
    without reading the device. A too-large hint only costs a larger bucket:
    the solver masks by the device-side count. A batched state solves its B
    graphs at once, at the bucket of its largest count, each masked by its
    own."""
    del cfg  # kept for the reference's signature
    count = (profiling.host_read(state.db.count.max(), int) if count_hint is None
             else int(count_hint))
    if count < 1:
        return state._replace(pending_solve=torch.zeros_like(state.pending_solve))
    cap = state.db.capacity
    bucket = next((b for b in _SOLVE_BUCKETS if count <= b <= cap), cap)
    g = state.graph
    g_b = g._replace(odom_rel_rot=g.odom_rel_rot[..., :bucket, :, :],
                     odom_rel_trans=g.odom_rel_trans[..., :bucket, :])
    sol = solve_pose_graph(g_b, state.db.rot[..., :bucket, :, :], state.db.trans[..., :bucket, :],
                           state.db.count, method="bcr")
    if state.xyz.dim() == 1:  # as a batch of one, so it rounds as an instance of a batch
        return tree_index(_apply_solution(tree_index(state, None), sol.rot[None],
                                          sol.trans[None]), 0)
    return _apply_solution(state, sol.rot, sol.trans)


def _insert_loop(state: BackendState, factor: loopmod.LoopFactor) -> BackendState:
    """Add an accepted loop factor, mark its current keyframe matched and
    count a drop when the store is full (backend.py:388-396)."""
    loops = state.graph.loops
    drop = factor.accepted & (loops.count >= loops.capacity)
    loops = add_between(loops, factor.i, factor.j, factor.rel_rot, factor.rel_trans,
                        factor.noise_var, factor.robust_c, enable=factor.accepted)
    write_row_(state.loop_matched, factor.i, True, factor.accepted)
    return state._replace(graph=state.graph._replace(loops=loops),
                          pending_solve=state.pending_solve | factor.accepted,
                          dropped_counts=_count_drop(state.dropped_counts, 1, drop))


def _try_close(state: BackendState, cur, prev_idx, init_yaw, robust: bool, src_cap: int,
               tgt_cap: int, cfg: RoloConfig) -> loopmod.LoopFactor:
    """Assemble both submaps and ICP-verify one loop candidate."""
    lc, leaf = cfg.loop, cfg.mapping.mapping_surf_leaf_size
    cur_sub = loopmod.assemble_loop_submap(state.db, cur, 0, src_cap, leaf)
    prev_sub = loopmod.assemble_loop_submap(state.db, prev_idx, lc.history_search_num, tgt_cap,
                                            leaf)
    # exact k-NN: the accept / reject fitness must not be approximately scored
    return loopmod.verify_loop(
        state.db, cur, prev_idx, cur_sub, prev_sub, init_yaw,
        max_corr_dist=(150.0 if robust else lc.history_search_radius * 2.0),
        fitness_threshold=lc.history_fitness_score, robust=robust, approx_knn=False)


def loop_closure_step(state: BackendState, cfg: RoloConfig) -> Tuple[BackendState, torch.Tensor]:
    """One loop-closure pass (backend.py:330-424): scan-context detection,
    then radius-search detection (which sees the keyframes the first marked
    matched), per `loop_close_type`; ICP verification and factor insertion.
    Returns (state, closed_any)."""
    lc, st = cfg.loop, cfg.static
    dev = state.xyz.device
    cur = torch.clamp(state.db.count - 1, min=0)
    closed = torch.tensor(False, device=dev)
    if not lc.enable:
        return state, closed
    src_cap = min(lc.icp_src_capacity, st.max_submap_points // 2)
    tgt_cap = min(lc.icp_tgt_capacity, st.max_submap_points)
    if lc.loop_close_type in ("sc", "all"):
        det = sc.detect_loop(state.scdb, lc)
        if profiling.host_read(det.found & (det.index != cur) & (state.db.count > 0)):
            factor = _try_close(state, cur, det.index, det.yaw_rad, True, src_cap, tgt_cap, cfg)
            state = _insert_loop(state, factor)
            closed = closed | factor.accepted
    if lc.loop_close_type in ("rs", "all"):
        prev_idx, found = loopmod.detect_loop_distance(
            state.db, state.loop_matched, lc.history_search_radius, lc.history_search_time_diff)
        if profiling.host_read(found):
            factor = _try_close(state, cur, prev_idx, 0.0, False, src_cap, tgt_cap, cfg)
            state = _insert_loop(state, factor)
            closed = closed | factor.accepted
    return state, closed


def external_loop_step(state: BackendState, time_cur, time_prev, cfg: RoloConfig
                       ) -> Tuple[BackendState, torch.Tensor]:
    """Accept one externally detected loop pair given as two stamps
    (backend.py:427-503): the earliest keyframe at or after `time_cur`, the
    latest at or before `time_prev`; pairs closer than
    `history_search_time_diff` are rejected; ICP-verified with the radius
    search's plain noise. Returns (state, closed)."""
    lc, st, db = cfg.loop, cfg.static, state.db
    dev = state.xyz.device
    time_cur = torch.as_tensor(time_cur, dtype=db.time.dtype, device=dev)
    time_prev = torch.as_tensor(time_prev, dtype=db.time.dtype, device=dev)
    idx = torch.arange(db.capacity, device=dev)
    valid = idx < db.count
    ge = valid & (db.time >= time_cur)
    key_cur = torch.where(ge.any(), torch.argmax(ge.to(torch.uint8)),
                          torch.clamp(db.count.long() - 1, min=0))
    key_prev = torch.max(torch.where(valid & (db.time <= time_prev), idx, 0))
    found = ((db.count >= 2) & (torch.abs(time_cur - time_prev) >= lc.history_search_time_diff)
             & (key_cur != key_prev) & ~read_row(state.loop_matched, key_cur))
    if not profiling.host_read(found):
        return state, torch.tensor(False, device=dev)
    factor = _try_close(state, key_cur.to(torch.int32), key_prev.to(torch.int32), 0.0, False,
                        st.max_submap_points // 2, st.max_submap_points, cfg)
    return _insert_loop(state, factor), factor.accepted


def prior_step(state: BackendState, ground_now: PaddedCloud, cfg: RoloConfig
               ) -> Tuple[BackendState, torch.Tensor]:
    """One prior-association pass (backend.py:506-579): the xy gate over the
    whole queue at once, then the ICP and the remaining gates on the single
    nearest eligible entry. Returns (state, matched_any)."""
    q, db = state.prior_queue, state.db
    dev = state.xyz.device
    cur = torch.clamp(db.count - 1, min=0)
    cur_rot, cur_trans = read_row(db.rot, cur), read_row(db.trans, cur)
    linked_all = torch.clamp(q.linked_key.long(), max=db.capacity - 1)
    prior_xy = ((db.rot[linked_all] @ q.rel_trans[..., None])[..., 0]
                + db.trans[linked_all])[:, :2]
    d2 = torch.sum((prior_xy - cur_trans[:2]) ** 2, dim=-1)
    eligible = (q.valid & (torch.arange(q.capacity, device=dev) < q.count)
                & (q.linked_key != cur) & (d2 < cfg.prior.near_prior_radius ** 2)
                & (db.count > 0))
    score = torch.where(eligible, d2, float("inf"))
    pick = torch.argmin(score)
    if not profiling.host_read(torch.isfinite(read_row(score, pick))):
        return state, torch.tensor(False, device=dev)
    linked = read_row(linked_all, pick)
    factor = priormod.associate_prior(
        read_row(q.rel_rot, pick), read_row(q.rel_trans, pick), read_row(q.linked_key, pick),
        PaddedCloud(read_row(q.patch_xyz, pick), read_row(q.patch_mask, pick)), True,
        read_row(db.rot, linked), read_row(db.trans, linked), cur, cur_rot, cur_trans,
        ground_now, cfg.prior, approx_knn=cfg.mapping.approx_knn)
    priors = state.graph.priors
    drop = factor.accepted & (priors.count >= priors.capacity)
    priors = add_between(priors, factor.i, factor.j, factor.rel_rot, factor.rel_trans,
                         factor.noise_var, enable=factor.accepted)
    return state._replace(graph=state.graph._replace(priors=priors),
                          pending_solve=state.pending_solve | factor.accepted,
                          dropped_counts=_count_drop(state.dropped_counts, 2, drop)
                          ), factor.accepted


def record_prior_observation(state: BackendState, obs: priormod.PriorObservation,
                             obs_time=None, cfg: RoloConfig = None) -> BackendState:
    """priorInfoHandler (backend.py:582-615): store the observation relative
    to the latest keyframe. With `obs_time` the reference's gates apply: more
    than 10 keyframes, within 10 ms of the latest keyframe's stamp, and at
    least `synced_interval` after the last accepted prior."""
    db, q = state.db, state.prior_queue
    cur = torch.clamp(db.count - 1, min=0)
    enable = db.count > 0
    if obs_time is not None:
        obs_time = torch.as_tensor(obs_time, dtype=db.time.dtype, device=db.time.device)
        synced = cfg.prior.synced_interval if cfg is not None else 0.0
        enable = (enable & (db.count > 10)
                  & (torch.abs(obs_time - read_row(db.time, cur)) < 1e-2)
                  & (obs_time - q.last_time >= synced))
    wrapped = enable & obs.success & (q.count >= q.capacity)
    q = priormod.push_prior(q, obs, cur, read_row(db.rot, cur), read_row(db.trans, cur),
                            enable=enable, obs_time=obs_time)
    return state._replace(prior_queue=q,
                          dropped_counts=_count_drop(state.dropped_counts, 3, wrapped))


def backend_state_to_numpy(state) -> dict:
    """A BackendState (this package's or the JAX package's) as numpy arrays
    keyed by field path, nested NamedTuples flattened: "db.rot",
    "graph.loops.i", "rpy", ..."""
    return tree_to_numpy(state)


def backend_state_from_numpy(arrays: Mapping, device) -> BackendState:
    """A BackendState on `device` from `backend_state_to_numpy`'s layout,
    with the same shapes and dtypes (writable copies)."""
    return tree_from_numpy(BackendState, arrays, device)
