"""The SLAM system, torch port of `rolo_tpu/runtime/slam.py`.

One `SlamSystem` runs the whole per-scan pipeline of the reference's five
ROS nodes: range-image projection with the ESKF-fed deskew, LOAM features,
the rot-GICP front-end, ESKF fusion, back-end mapping at
mappingProcessInterval, the live ground map, loop closure at
loopClosureFrequency and the ground priors at priorFactorFrequency, with
the graph solve scheduled from host-side knowledge. All SLAM state lives on
`device` (the card unless the caller asks for the CPU); the checkpoint is
the JAX package's file layout (`runtime/io.py`).

Host <-> device traffic per scan is one copy in (the padded scan, from
pinned memory) and one copy out (the published poses, into pinned memory,
started without waiting). The steps the runtime calls keep their own host
syncs (the LM loops' convergence tests, one host branch per `lax.cond` of
the reference); `process_scan` adds none: the scheduler's state (cadence
clocks, `_graph_dirty`, the mapping-step count) is host-side by design.
"""

from __future__ import annotations

import math
import os
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import RoloConfig
from ..filter import fusion
from ..frontend import odometry
from ..geometry import so3
from ..mapping import backend
from ..pointcloud import features as feats
from ..pointcloud.cloud import PaddedCloud, concat_clouds
from ..pointcloud.projection import RawScan, project_scan
from ..prior import ground as prior_ground
from ..prior import vehicle as prior_vehicle
from . import io as rio
from .cycles import ground_update, prior_cycle
from .platform import configure_precision, default_device
from . import profiling
from .profiling import StageTimers


def deskew_increment(fusion_state: fusion.FusionState, odom_state: odometry.OdometryState,
                     interval: float):
    """Deskew increment for the upcoming sweep, in the step convention
    (the projection applies -rpy * ratio and +vel * ratio), from the
    ESKF's smoothed body rates and velocity once the filter runs, else
    from the last registration step (slam.py:184-207). Feeding the raw
    step back alone is unstable: a step error warps the next scan,
    which biases the next step."""
    f = fusion_state.filter
    o = odom_state
    rot = torch.where(f.initialized, so3.exp(-f.omega * interval), o.step_rot)
    vel = torch.where(f.initialized, (f.rot.T @ f.vel) * interval,
                      -o.step_rot.T @ o.step_trans)
    return torch.stack(so3.matrix_to_rpy(rot)), vel


def ground_map_from_points(points, device) -> prior_ground.GroundMap:
    """A ground map of `points` [M, 3] (numpy or a tensor), padded to the
    next power of two."""
    points = points.detach().cpu().numpy() if isinstance(points, torch.Tensor) else points
    cap = 1 << int(np.ceil(np.log2(max(len(points), 1))))
    cloud = PaddedCloud.from_points(points, cap, device)
    return prior_ground.GroundMap(cloud.xyz, cloud.mask)


def infer_rings(xyz: np.ndarray, n_scan: int, fov_up_deg: float = 15.0,
                fov_down_deg: float = -25.0) -> np.ndarray:
    """Ring index from vertical angle for sensors without a ring field
    (widens ingest to plain xyz clouds such as KITTI .bin)."""
    d = np.linalg.norm(xyz[:, :2], axis=1)
    ang = np.degrees(np.arctan2(xyz[:, 2], np.maximum(d, 1e-9)))
    frac = (fov_up_deg - ang) / max(fov_up_deg - fov_down_deg, 1e-6)
    return np.clip((frac * (n_scan - 1)).round(), 0, n_scan - 1).astype(np.int32)


def infer_rel_time(xyz: np.ndarray, scan_period: float) -> np.ndarray:
    """Per-point time from the azimuth sweep (the reference's deskewCloudInfo
    fallback, imageProjection.cpp:266-366: orientation span mapped to
    scanPeriod)."""
    ang = np.arctan2(xyz[:, 1], xyz[:, 0])
    rel = (ang[0] - ang) % (2.0 * math.pi)
    return (rel / (2.0 * math.pi) * scan_period).astype(np.float32)


class CapacityExhausted(RuntimeError):
    """A fixed-capacity store dropped an event and
    StaticConfig.on_capacity == "error"."""


_DROP_CATEGORIES = ("keyframes", "loop_factors", "prior_factors", "prior_queue_overwrites")


class SlamSystem:
    """One SLAM run over a scan stream.

    Usage:
        slam = SlamSystem(RoloConfig())            # on the card
        for stamp, points in scans:
            slam.process_scan(points, stamp)
            pose = slam.published()                # the scan's poses, on the host
        slam.save_results("/tmp/out")
    """

    # scans a queued background task may wait for a mapping-free scan
    # before being dispatched anyway (bounded staleness)
    BG_MAX_DEFER = 3

    def __init__(self, cfg: RoloConfig = RoloConfig(), device=None):
        configure_precision()  # a user's entry point: full-f32 matmuls
        self.cfg = cfg
        self.device = torch.device(default_device() if device is None else device)
        dev, st = self.device, cfg.static
        self.odom_state = odometry.init_state(st.max_feature_points, dev)
        self.fusion_state = fusion.init_fusion(cfg.filter, dev)
        self.backend_state = backend.init_backend(cfg, dev)
        self.vehicle = prior_vehicle.from_config(cfg.prior, dev)
        # external ground map (set_ground_map); without one, the live
        # ground map built from segmented scans feeds the prior stack
        self.ground_map: Optional[prior_ground.GroundMap] = None
        self.live_ground = prior_ground.init_live_ground(st.live_ground_slots,
                                                         st.live_ground_slot_points, dev)

        self._last_mapping_time = -np.inf
        self._last_loop_time = -np.inf
        self._last_prior_time = -np.inf
        self._last_stamp: Optional[float] = None
        # stamps are rebased to the first scan on the host, in f64: f32 on
        # the device cannot resolve a scan period at UNIX-epoch magnitudes
        self._epoch: Optional[float] = None

        # per-stage wall clock; with sync_stages (the tracer's switch) each
        # stage waits for its own outputs, so stage times hold the device
        # time (at an end-to-end cost), and the stages' spans and counters
        # are recorded
        self.timers = StageTimers()

        self.drop_counts = dict.fromkeys(_DROP_CATEGORIES, 0)
        self._warned_drops = set()
        # externally injected loop pairs, (time_cur, time_prev) raw stamps
        self._external_loops: List[tuple] = []

        # trajectory logs: device tensors, stacked and copied once at egress
        self.times: List[float] = []
        self.front_positions: List[torch.Tensor] = []
        self.front_rots: List[torch.Tensor] = []
        self.mapped_positions: List[torch.Tensor] = []
        self.mapped_rots: List[torch.Tensor] = []
        # fused pose stream: mapping o (front_anchor^-1 o ESKF-now)
        self.fused_positions: List[torch.Tensor] = []
        self.fused_rots: List[torch.Tensor] = []
        self.fused_valid: List[torch.Tensor] = []
        self._mapping_steps = 0
        self._last_capacity_check = 0
        self._pending_capacity = None  # (pinned counts, event) of the last check
        # background scheduler: pending cadence work and the scans its head
        # has been deferred
        self._bg_queue: List[str] = []
        self._bg_deferred = 0
        self._bg_enqueued: Dict[str, int] = {}  # task -> the scan it was queued on
        # True once a loop / prior / external program ran since the last solve
        self._graph_dirty = False
        self._next_solve_check = 0.0

        cuda = self.device.type == "cuda"
        cap = st.max_raw_points
        # the padded scan: xyz f32 [cap, 3], ring i32, rel_time f32, mask
        # bool, packed in one pinned buffer so it crosses in one copy
        self._ingest_host = torch.zeros(cap * 21, dtype=torch.uint8, pin_memory=cuda)
        self._ingest_event = None
        self._published_host = None
        self._published_layout: List[tuple] = []
        self._published_event = None

    @property
    def sync_stages(self) -> bool:
        """Trace the stages (`StageTimers.tracing`): each syncs on its own
        outputs and opens a profiler range, and the modules' spans and
        counters are recorded. Off by default."""
        return self.timers.tracing

    @sync_stages.setter
    def sync_stages(self, on: bool) -> None:
        self.timers.tracing = bool(on)

    # -- ingest ----------------------------------------------------------

    def set_ground_map(self, points) -> None:
        """External ground map (the "/voxel_map" input of the reference's
        ground_mapping node)."""
        self.ground_map = ground_map_from_points(points, self.device)

    def inject_loop(self, time_cur: float, time_prev: float) -> None:
        """Queue an externally detected loop pair by raw stamps (the
        loop_info input of detectLoopClosureExternal,
        backMapping.cpp:2517-2570); verified at the next loop tick."""
        self._external_loops.append((float(time_cur), float(time_prev)))

    def _host_views(self, cap: int):
        h = self._ingest_host.numpy()
        return (h[:12 * cap].view(np.float32).reshape(cap, 3),
                h[12 * cap:16 * cap].view(np.int32), h[16 * cap:20 * cap].view(np.float32),
                h[20 * cap:].view(np.bool_))

    def _make_raw_scan(self, points, ring, rel_time) -> RawScan:
        cfg = self.cfg
        cap = cfg.static.max_raw_points
        if isinstance(points, torch.Tensor):
            return self._raw_scan_from_tensor(points, ring, rel_time, cap)
        pts = np.asarray(points, np.float32).reshape(-1, points.shape[-1])
        xyz = pts[:, :3]
        if ring is None:
            ring = infer_rings(xyz, cfg.sensor.n_scan)
        if rel_time is None:
            rel_time = infer_rel_time(xyz, cfg.sensor.scan_period)
        m = min(len(xyz), cap)
        if self._ingest_event is not None:  # the last scan's copy has left the buffer
            profiling.host_read(self._ingest_event, torch.cuda.Event.synchronize)
        xyz_p, ring_p, t_p, mask = self._host_views(cap)
        xyz_p[:m], xyz_p[m:] = xyz[:m], 0.0
        ring_p[:m], ring_p[m:] = np.asarray(ring)[:m], 0
        t_p[:m], t_p[m:] = np.asarray(rel_time)[:m], 0.0
        mask[:m], mask[m:] = True, False
        buf = self._ingest_host.to(self.device, non_blocking=True, copy=True)
        if self.device.type == "cuda":
            self._ingest_event = torch.cuda.Event()
            self._ingest_event.record()
        return RawScan(buf[:12 * cap].view(torch.float32).reshape(cap, 3),
                       buf[12 * cap:16 * cap].view(torch.int32),
                       buf[16 * cap:20 * cap].view(torch.float32),
                       buf[20 * cap:].view(torch.bool))

    def _raw_scan_from_tensor(self, points: torch.Tensor, ring, rel_time, cap: int) -> RawScan:
        """The padded scan from a tensor, built where it lies (a frame already
        on the card does not cross to the host). Rings and times it lacks are
        inferred from a host copy by `infer_rings` / `infer_rel_time`, the
        reference's f32 numpy arithmetic: computed by torch, a point halfway
        between two rings (a VLP-16 has four such beams under the assumed
        field of view) could round to the other one."""
        dev = self.device
        xyz = points.reshape(-1, points.shape[-1])[:, :3].to(dev, torch.float32)
        host = xyz.cpu().numpy() if ring is None or rel_time is None else None
        ring = torch.as_tensor(infer_rings(host, self.cfg.sensor.n_scan) if ring is None
                               else ring, device=dev)
        rel_time = torch.as_tensor(infer_rel_time(host, self.cfg.sensor.scan_period)
                                   if rel_time is None else rel_time, device=dev)
        m = min(xyz.shape[0], cap)
        xyz_p = torch.zeros(cap, 3, device=dev)
        ring_p = torch.zeros(cap, dtype=torch.int32, device=dev)
        t_p = torch.zeros(cap, device=dev)
        xyz_p[:m], ring_p[:m], t_p[:m] = xyz[:m], ring[:m], rel_time[:m]
        return RawScan(xyz_p, ring_p, t_p, torch.arange(cap, device=dev) < m)

    # -- main per-scan entry ---------------------------------------------

    def _deskew_increment(self, interval: float):
        return deskew_increment(self.fusion_state, self.odom_state, interval)

    def process_scan(self, points, stamp: float, ring=None, rel_time=None
                     ) -> Dict[str, torch.Tensor]:
        """Push one scan through the pipeline. `points` [N, >=3] is a numpy
        array or a tensor (a tensor on the card stays there); `ring` and
        `rel_time` are inferred when absent. Returns the scan's front-end,
        mapped (when the mapping cadence fired) and fused poses as device
        tensors; `published()` reads them on the host."""
        cfg, st = self.cfg, self.cfg.static
        if self._epoch is None:
            self._epoch = stamp
        stamp = float(stamp - self._epoch)
        interval = (cfg.sensor.scan_period if self._last_stamp is None
                    else max(stamp - self._last_stamp, 1e-3))
        self._last_stamp = stamp

        prof = self.sync_stages
        with self.timers.stage("ingest"):
            scan = self._make_raw_scan(points, ring, rel_time)
        with self.timers.stage("project+features", sync=(lambda: feat.xyz) if prof else None):
            interval_t = torch.full((), interval, dtype=torch.float32, device=self.device)
            s = cfg.sensor
            if s.deskew_enabled:
                step_rpy, step_vel = self._deskew_increment(interval)
                ring_img = project_scan(scan, s.n_scan, s.horizon_scan, s.lidar_min_range,
                                        s.lidar_max_range, s.downsample_rate, deskew_rpy=step_rpy,
                                        odom_time_diff=interval_t, deskew_vel=step_vel)
            else:
                ring_img = project_scan(scan, s.n_scan, s.horizon_scan, s.lidar_min_range,
                                        s.lidar_max_range, s.downsample_rate)
            fc = feats.extract_features(ring_img, cfg.features.edge_threshold,
                                        cfg.features.surf_threshold,
                                        cfg.features.odometry_surf_leaf_size,
                                        st.max_corner_points, st.max_surf_points)
            feat = concat_clouds(fc.corners, fc.surfaces, st.max_feature_points)

        with self.timers.stage("frontend", sync=(lambda: odom_out.pose_trans) if prof else None):
            self.odom_state, odom_out = odometry.scan_step(
                self.odom_state, feat.xyz, feat.mask, interval_t, cfg.registration,
                st.max_voxels, cfg.registration.k_correspondences,
                enable_failure_gate=cfg.registration.enable_failure_gate)
        front_rot, front_trans = odom_out.pose_rot, odom_out.pose_trans

        # ESKF fusion measurement
        self.fusion_state, _ = fusion.on_front_odometry(self.fusion_state, stamp, front_rot,
                                                        front_trans, cfg.filter)
        out: Dict[str, torch.Tensor] = {"front_rot": front_rot, "front_trans": front_trans}

        # back-end at mappingProcessInterval (backMapping.cpp:436)
        if stamp - self._last_mapping_time >= cfg.mapping.mapping_process_interval:
            self._last_mapping_time = stamp
            raw_cloud = PaddedCloud(ring_img.xyz.reshape(-1, 3), ring_img.mask.reshape(-1))
            sc_cloud = raw_cloud if cfg.loop.sc_input_type == "scan_raw" else fc.surfaces
            with self.timers.stage("backend", sync=(lambda: map_out.trans) if prof else None):
                self.backend_state, map_out = backend.backend_step(
                    self.backend_state, fc.corners, fc.surfaces, sc_cloud, front_rot,
                    front_trans, True, stamp, cfg)
            mapped_rot, mapped_trans = map_out.rot, map_out.trans
            self.fusion_state = fusion.on_mapping_odometry(self.fusion_state, mapped_rot,
                                                           mapped_trans, front_rot, front_trans)
            out["mapped_rot"] = mapped_rot
            out["mapped_trans"] = mapped_trans
            out["keyframe_added"] = map_out.keyframe_added
            # live ground map at the mapping cadence: this scan's segmented
            # ground at the freshly mapped pose
            if cfg.prior.enable and self.ground_map is None:
                self.live_ground = ground_update(self.live_ground, ring_img, mapped_rot,
                                                 mapped_trans, cfg)
            self.mapped_positions.append(mapped_trans)
            self.mapped_rots.append(mapped_rot)
            self._mapping_steps += 1

        # fused pose publication (fusionTimerHandler, lidarOdometry.cpp:
        # 137-250): one fused sample per scan
        fp = fusion.fused_pose(self.fusion_state, stamp, cfg.filter)
        out["fused_rot"] = fp.rot
        out["fused_trans"] = fp.trans
        out["fused_valid"] = fp.valid
        self.fused_positions.append(fp.trans)
        self.fused_rots.append(fp.rot)
        self.fused_valid.append(fp.valid)

        # Publication point: the poses' device -> host copy is enqueued
        # before any background work, so a consumer's fetch never waits
        # behind a loop verification, a prior cycle or a graph solve.
        self._publish(out)

        # Background cadence (loopClosureThread @ 1 Hz, priorThread @ 5 Hz,
        # the graph solve; backMapping.cpp:2710-2712). Ticks only enqueue;
        # at most one queued task is dispatched per scan, preferably on a
        # scan where the mapping cadence did not fire, and a task waits at
        # most BG_MAX_DEFER scans. The solve gate is host-side: loop / prior
        # / external programs are the only sources of new factors, and the
        # host knows when it dispatched one.
        if cfg.loop.enable and stamp - self._last_loop_time >= 1.0 / cfg.loop.frequency_hz:
            self._last_loop_time = stamp
            self._enqueue("loop")
        # the prior cycle is cheap and runs inline at its 5 Hz cadence: a
        # scheduler slot would starve the expensive tasks onto mapping scans
        if (cfg.prior.enable and (self.ground_map is not None or self._mapping_steps >= 1)
                and stamp - self._last_prior_time >= 1.0 / cfg.prior.frequency_hz):
            self._last_prior_time = stamp
            self._dispatch_background("prior", stamp, out, prof)
        if self._graph_dirty and self._mapping_steps >= 1 and stamp >= self._next_solve_check:
            self._next_solve_check = stamp + cfg.mapping.graph_solve_check_interval
            self._graph_dirty = False
            self._enqueue("solve")

        mapping_fired = "mapped_trans" in out
        if self._bg_queue and (not mapping_fired or self._bg_deferred >= self.BG_MAX_DEFER):
            self._bg_deferred = 0
            self._dispatch_background(self._dequeue(), stamp, out, prof)
        elif self._bg_queue:
            self._bg_deferred += 1

        # capacity accounting every 10 mapping steps, fetch-deferred: the
        # counts' copy starts now and is read at the next check, when it
        # has long landed (finalize() still reads fresh)
        if self._mapping_steps >= self._last_capacity_check + 10:
            self._last_capacity_check = self._mapping_steps
            pending = self._pending_capacity
            if pending is not None:
                if pending[1] is not None:
                    pending[1].synchronize()
                self._check_capacity(pending[0].numpy().copy())
            self._pending_capacity = self._copy_out(self.backend_state.dropped_counts,
                                                    None if pending is None else pending[0])

        self.times.append(stamp)
        self.front_positions.append(front_trans)
        self.front_rots.append(front_rot)
        return out

    def _enqueue(self, task: str) -> None:
        if task not in self._bg_queue:
            self._bg_queue.append(task)
            self._bg_enqueued[task] = len(self.times)

    def _dequeue(self) -> str:
        """The queue's head; traced, the scans it waited from its enqueue
        (`scheduler.wait_scans`)."""
        task = self._bg_queue.pop(0)
        queued = self._bg_enqueued.pop(task, None)
        if queued is not None:
            self.timers.count("scheduler.wait_scans", len(self.times) - queued)
        return task

    def _copy_out(self, value: torch.Tensor, host: Optional[torch.Tensor] = None):
        """Start a device -> host copy of `value` into pinned memory (`host`
        when given) without waiting: (host tensor, CUDA event or None)."""
        if host is None or host.shape != value.shape or host.dtype != value.dtype:
            host = torch.empty(value.shape, dtype=value.dtype,
                               pin_memory=self.device.type == "cuda")
        host.copy_(value, non_blocking=True)
        if self.device.type != "cuda":
            return host, None
        event = torch.cuda.Event()
        event.record()
        return host, event

    def _publish(self, out: Dict[str, torch.Tensor]) -> None:
        """Pack the scan's poses into one f32 vector and start its copy."""
        self._published_layout = [(k, tuple(v.shape), v.dtype) for k, v in out.items()]
        flat = torch.cat([v.reshape(-1).to(torch.float32) for v in out.values()])
        self._published_host, self._published_event = self._copy_out(flat, self._published_host)

    def published(self) -> Dict[str, np.ndarray]:
        """The last scan's poses on the host (what `process_scan` returned),
        waiting for their copy only."""
        if self._published_host is None:
            raise RuntimeError("published() before any scan was processed")
        if self._published_event is not None:
            self._published_event.synchronize()
        flat = self._published_host.numpy().copy()
        res, o = {}, 0
        for key, shape, dtype in self._published_layout:
            n = int(np.prod(shape))
            v = flat[o:o + n].reshape(shape)
            res[key] = v > 0.5 if dtype == torch.bool else v
            o += n
        return res

    def _dispatch_background(self, task: str, stamp: float, out: Dict, prof: bool) -> None:
        """Run one background-cadence program (the reference's detached
        thread bodies: loopClosureThread / priorThread / isam->update,
        backMapping.cpp:1904-1941, 2710-2712)."""
        cfg = self.cfg
        if task == "loop":
            with self.timers.stage("loop_closure",
                                   sync=(lambda: out["loop_closed"]) if prof else None):
                # externally injected pairs first, one per pass
                if self._external_loops:
                    t_cur, t_prev = self._external_loops.pop(0)
                    self.backend_state, ext_closed = backend.external_loop_step(
                        self.backend_state, t_cur - self._epoch, t_prev - self._epoch, cfg)
                    out["loop_closed_external"] = ext_closed
                self.backend_state, closed = backend.loop_closure_step(self.backend_state, cfg)
                out["loop_closed"] = closed
            self._graph_dirty = True
        elif task == "prior":
            # the external ground map when given, else the live one
            gm = self.ground_map if self.ground_map is not None else \
                self.live_ground.as_ground_map()
            with self.timers.stage("prior", sync=(lambda: matched) if prof else None):
                self.backend_state, matched = prior_cycle(self.fusion_state, stamp,
                                                          self.backend_state, gm, self.vehicle,
                                                          cfg)
            self._graph_dirty = True
        elif task == "solve":
            with self.timers.stage("graph_solve",
                                   sync=(lambda: self.backend_state.xyz) if prof else None):
                self.backend_state = backend.solve_graph_host(
                    self.backend_state, cfg, count_hint=self._mapping_steps + 1)

    def _check_capacity(self, counts: Optional[np.ndarray] = None) -> None:
        """Surface BackendState.dropped_counts: warn once per category or
        raise, per StaticConfig.on_capacity. `counts`: a fetched snapshot;
        None reads the live state (blocking)."""
        if counts is None:
            counts = self.backend_state.dropped_counts.cpu().numpy()
        for name, n in zip(_DROP_CATEGORIES, counts):
            n = int(n)
            if n <= self.drop_counts[name]:
                continue
            self.drop_counts[name] = n
            msg = (f"rolo_tpu_torch: capacity exhausted for '{name}' ({n} events dropped); "
                   f"raise the corresponding StaticConfig limit")
            if self.cfg.static.on_capacity == "error" and name != "prior_queue_overwrites":
                raise CapacityExhausted(msg)
            if name not in self._warned_drops:
                self._warned_drops.add(name)
                warnings.warn(msg, RuntimeWarning)

    def finalize(self) -> None:
        """Flush end-of-run work: drain the queued background tasks, apply a
        pending graph solve (loops near the end of a run find no later
        keyframe to trigger one) and check the capacities. Idempotent."""
        while self._bg_queue:
            self._dispatch_background(self._dequeue(),
                                      self._last_stamp if self._last_stamp is not None else 0.0,
                                      {}, False)
        if self._graph_dirty or bool(self.backend_state.pending_solve):
            self._graph_dirty = False
            with self.timers.stage("graph_solve", sync=(lambda: self.backend_state.xyz)
                                   if self.sync_stages else None):
                self.backend_state = backend.solve_graph_host(self.backend_state, self.cfg)
        self._check_capacity()

    # -- between-scan pose queries ---------------------------------------

    def fused_pose_at(self, stamp: float) -> Dict[str, np.ndarray]:
        """The fused pose at any query time (the consumer API of the
        reference's 20 Hz fusionTimerHandler, lidarOdometry.cpp:137-250):
        dead-reckons a copy of the filter to `stamp`, never advancing it.
        One device fetch."""
        if self._epoch is None:
            raise RuntimeError("fused_pose_at before any scan was processed")
        fp = fusion.fused_pose(self.fusion_state, float(stamp - self._epoch), self.cfg.filter)
        flat = torch.cat([fp.trans, fp.rot.reshape(-1), fp.velocity, fp.speed[None],
                          fp.valid.to(torch.float32)[None]]).cpu().numpy()
        return {"trans": flat[:3], "rot": flat[3:12].reshape(3, 3), "velocity": flat[12:15],
                "speed": float(flat[15]), "valid": bool(flat[16])}

    def future_path(self) -> Dict[str, np.ndarray]:
        """The predictTimerHandler output (lidarOdometry.cpp:252-322): the
        ESKF rollout polyline at 0.2 s steps to the 8 m budget in the current
        lidar frame with z zeroed, and the final pose the prior chain reads.
        One device fetch."""
        pred = fusion.predict_future(self.fusion_state, self.cfg.filter)
        m = pred.local_pos.shape[0]
        flat = torch.cat([pred.local_pos.reshape(-1), pred.local_quat.reshape(-1),
                          pred.mask.to(torch.float32), pred.final_pos, pred.final_quat,
                          pred.local_velocity, pred.heading_rate[None],
                          pred.valid.to(torch.float32)[None]]).cpu().numpy()
        o = 0
        pos = flat[o:o + 3 * m].reshape(m, 3)
        o += 3 * m
        quat = flat[o:o + 4 * m].reshape(m, 4)
        o += 4 * m
        mask = flat[o:o + m] > 0.5
        o += m
        return {"path_pos": pos[mask], "path_quat_wxyz": quat[mask], "final_pos": flat[o:o + 3],
                "final_quat_wxyz": flat[o + 3:o + 7], "local_velocity": flat[o + 7:o + 10],
                "heading_rate": float(flat[o + 10]), "valid": bool(flat[o + 11])}

    def keyframe_marginal_covariance(self, indices) -> np.ndarray:
        """[M, 6, 6] marginal covariance blocks (rotvec, translation) of the
        requested keyframes under the current pose graph
        (isam->marginalCovariance, backMapping.cpp:1161). One fetch."""
        from ..graph.solver import marginal_covariance

        st = self.backend_state
        keys = torch.as_tensor(np.asarray(indices), dtype=torch.int32, device=self.device)
        return marginal_covariance(st.graph, st.db.rot, st.db.trans, st.db.count,
                                   keys).cpu().numpy()

    # -- egress ----------------------------------------------------------

    @staticmethod
    def _np_stack(tensors, width) -> np.ndarray:
        """One-copy stack of a tensor list (empty-safe)."""
        if not tensors:
            return np.zeros((0, width), np.float32)
        return torch.stack(tensors).cpu().numpy()

    @staticmethod
    def _np_quats(rots) -> np.ndarray:
        if not rots:
            return np.zeros((0, 4), np.float32)
        return so3.matrix_to_quat(torch.stack(rots)).cpu().numpy()

    def front_positions_np(self) -> np.ndarray:
        return self._np_stack(self.front_positions, 3)

    def front_quats_np(self) -> np.ndarray:
        return self._np_quats(self.front_rots)

    def mapped_positions_np(self) -> np.ndarray:
        return self._np_stack(self.mapped_positions, 3)

    def mapped_quats_np(self) -> np.ndarray:
        return self._np_quats(self.mapped_rots)

    def fused_trajectory_np(self):
        """(times, positions, quats) of the valid fused pose samples."""
        if not self.fused_positions:
            return np.zeros((0,)), np.zeros((0, 3), np.float32), np.zeros((0, 4), np.float32)
        valid = torch.stack(self.fused_valid).cpu().numpy()
        pos = self._np_stack(self.fused_positions, 3)
        quat = self._np_quats(self.fused_rots)
        times = np.asarray(self.times)
        return times[valid], pos[valid], quat[valid]

    def keyframe_trajectory(self):
        """(times, positions, quats_wxyz) of the optimized keyframe poses,
        after any pending correction (finalize). One fetch."""
        self.finalize()
        db = self.backend_state.db
        k = int(db.count)
        flat = torch.cat([db.time[:k, None], db.trans[:k], so3.matrix_to_quat(db.rot[:k])],
                         dim=1).cpu().numpy()
        return flat[:, 0], flat[:, 1:4], flat[:, 4:8]

    def save_results(self, out_dir: str) -> None:
        """End-of-run export: TUM trajectories, the g2o graph and the keyframe
        map PCD (saveTUM / saveGlobalPCDs, backMapping.cpp:1500-1608,
        2679-2699). The keyframe DB and the factor stores are fetched once."""
        self.finalize()
        os.makedirs(out_dir, exist_ok=True)
        rio.write_tum(os.path.join(out_dir, "front_end_tum.txt"), self.times,
                      self.front_positions_np(), self.front_quats_np())
        kt, kp, kq = self.keyframe_trajectory()
        rio.write_tum(os.path.join(out_dir, "optimized_tum.txt"), kt, kp, kq)
        ft, fpos, fq = self.fused_trajectory_np()
        if len(ft):
            rio.write_tum(os.path.join(out_dir, "fused_tum.txt"), ft, fpos, fq)

        # g2o: odometry chain + loop + prior edges
        st = self.backend_state
        k = int(st.db.count)
        g = st.graph
        rel_t = g.odom_rel_trans[1:k].cpu().numpy()
        rel_q = so3.matrix_to_quat(g.odom_rel_rot[1:k]).cpu().numpy()
        odom_edges = [(i - 1, i, rel_t[i - 1], rel_q[i - 1]) for i in range(1, k)]

        def edges_of(f):
            n = int(f.count)
            ij = torch.stack([f.i[:n], f.j[:n]], dim=1).cpu().numpy()
            t = f.rel_trans[:n].cpu().numpy()
            q = so3.matrix_to_quat(f.rel_rot[:n]).cpu().numpy()
            return [(int(ij[e, 0]), int(ij[e, 1]), t[e], q[e]) for e in range(n)]

        rio.write_g2o(os.path.join(out_dir, "pose_graph.g2o"), kp, kq, odom_edges,
                      edges_of(g.loops), edges_of(g.priors))

        # merged keyframe feature map
        db = st.db
        rot, trans = db.rot[:k].cpu().numpy(), db.trans[:k].cpu().numpy()
        parts = [(db.corner_xyz[:k].cpu().numpy(), db.corner_mask[:k].cpu().numpy()),
                 (db.surf_xyz[:k].cpu().numpy(), db.surf_mask[:k].cpu().numpy())]
        clouds = [xyz[i][mask[i]] @ rot[i].T + trans[i] for i in range(k) for xyz, mask in parts]
        if clouds:
            rio.write_pcd(os.path.join(out_dir, "global_map.pcd"), np.concatenate(clouds))

    def _states(self):
        return (self.odom_state, self.fusion_state, self.backend_state, self.live_ground)

    def checkpoint(self, path: str) -> None:
        """Write the full SLAM state (front-end, fusion, back-end, live
        ground map) with the host-side clocks, in the JAX package's file
        layout. Without the clocks a restore would rebase stamps to a new
        epoch while the keyframe times keep the old one."""
        self.finalize()  # pending corrections must survive the crash
        host = np.asarray([
            self._epoch if self._epoch is not None else np.nan,
            self._last_stamp if self._last_stamp is not None else np.nan,
            self._last_mapping_time, self._last_loop_time, self._last_prior_time,
            float(self._mapping_steps), self._next_solve_check,
        ], np.float64)
        rio.save_checkpoint(path, self._states(), host_meta=host)

    def restore(self, path: str) -> None:
        """Load a checkpoint written by either package."""
        states, host = rio.load_checkpoint(path, self._states(), with_host_meta=True)
        self.odom_state, self.fusion_state, self.backend_state, self.live_ground = states
        if host is not None:
            self._epoch = None if np.isnan(host[0]) else float(host[0])
            self._last_stamp = None if np.isnan(host[1]) else float(host[1])
            self._last_mapping_time = float(host[2])
            self._last_loop_time = float(host[3])
            self._last_prior_time = float(host[4])
            self._mapping_steps = int(host[5])
            self._next_solve_check = float(host[6])
