"""End-to-end dataset harness, torch port of `rolo_tpu/runtime/dataset.py`:
run a SlamSystem over a scan source, export trajectories, and score ATE/RPE
against ground truth.

Scan sources: the port's simulator (exact ground truth, frames already on
the device), a directory of KITTI .bin or PCD files (ground truth from a TUM
file), or a rosbag v2 through the native reader.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..config import RoloConfig
from ..geometry import so3
from . import io as rio
from . import metrics
from .slam import SlamSystem


@dataclass
class SequenceResult:
    n_scans: int = 0
    wall_s: float = 0.0
    scans_per_s: float = 0.0
    # ATE of the front-end (per-scan) and optimized keyframe trajectories
    ate_frontend: Optional[metrics.ATEResult] = None
    ate_keyframes: Optional[metrics.ATEResult] = None
    rpe_frontend: Optional[float] = None
    drop_counts: Dict[str, int] = field(default_factory=dict)
    stage_ms: Dict[str, float] = field(default_factory=dict)
    # loop / prior factors actually accepted into the graph
    n_keyframes: int = 0
    n_loop_factors: int = 0
    n_prior_factors: int = 0
    ate_keyframes_z_rmse: Optional[float] = None
    # roll/pitch RMSE (rad) of the optimized keyframe attitudes vs ground
    # truth, after the same alignment as the ATE
    ate_keyframes_rp_rmse: Optional[float] = None

    def to_json(self) -> dict:
        out = {
            "n_scans": self.n_scans,
            "wall_s": round(self.wall_s, 3),
            "scans_per_s": round(self.scans_per_s, 2),
            "drop_counts": self.drop_counts,
            "stage_ms": {k: round(v, 3) for k, v in self.stage_ms.items()},
            "n_keyframes": self.n_keyframes,
            "n_loop_factors": self.n_loop_factors,
            "n_prior_factors": self.n_prior_factors,
        }
        if self.ate_frontend is not None:
            out["ate_frontend_rmse_m"] = round(self.ate_frontend.rmse, 4)
        if self.ate_keyframes is not None:
            out["ate_keyframes_rmse_m"] = round(self.ate_keyframes.rmse, 4)
        if self.ate_keyframes_z_rmse is not None:
            out["ate_keyframes_z_rmse_m"] = round(self.ate_keyframes_z_rmse, 4)
        if self.ate_keyframes_rp_rmse is not None:
            out["ate_keyframes_rp_rmse_rad"] = round(self.ate_keyframes_rp_rmse, 5)
        if self.rpe_frontend is not None:
            out["rpe_frontend_rmse_m"] = round(self.rpe_frontend, 4)
        return out


def _host_rows(rows: list) -> list:
    """Host arrays of a list of tensors or arrays: one copy for tensors, so
    ground truth kept on the card costs no synchronization per scan."""
    if rows and isinstance(rows[0], torch.Tensor):
        return list(torch.stack(rows).cpu().numpy())
    return [np.asarray(r) for r in rows]


def run_frames(slam: SlamSystem, frames: Iterable,
               gt: Optional[List[Tuple[float, np.ndarray]]] = None,
               out_dir: Optional[str] = None, progress_every: int = 0) -> SequenceResult:
    """Drive `slam` over frames. Each frame needs .stamp / .points and may
    carry .ring / .rel_time / .gt_trans / .gt_rot (simulator frames do, as
    device tensors, fetched once after the run). `gt` optionally supplies
    (stamp, position) ground truth for other sources."""
    gt_times: List[float] = []
    gt_pos: list = []
    if gt:
        gt_times = [t for t, _ in gt]
        gt_pos = [p for _, p in gt]

    n = 0
    t_start = time.perf_counter()
    gt_rots: list = []
    for frame in frames:
        slam.process_scan(frame.points, frame.stamp, ring=getattr(frame, "ring", None),
                          rel_time=getattr(frame, "rel_time", None))
        if getattr(frame, "gt_trans", None) is not None and not gt:
            gt_times.append(frame.stamp)
            gt_pos.append(frame.gt_trans)
            if getattr(frame, "gt_rot", None) is not None:
                gt_rots.append(frame.gt_rot)
        n += 1
        if progress_every and n % progress_every == 0:
            print(f"  scan {n} ({time.perf_counter() - t_start:.1f}s)", flush=True)
    wall = time.perf_counter() - t_start
    gt_pos, gt_rots = _host_rows(gt_pos), _host_rows(gt_rots)
    # flush the pending solve and the final capacity check before reading
    slam.finalize()

    st = slam.backend_state
    res = SequenceResult(
        n_scans=n, wall_s=wall, scans_per_s=n / max(wall, 1e-9),
        drop_counts=dict(slam.drop_counts),
        stage_ms={k: v["mean_ms"] for k, v in slam.timers.summary().items()},
        n_keyframes=int(st.db.count), n_loop_factors=int(st.graph.loops.count),
        n_prior_factors=int(st.graph.priors.count),
    )

    if gt_pos:
        gt_t = np.asarray(gt_times)
        gt_p = np.asarray(gt_pos)
        # SlamSystem rebases stamps to the first scan
        est_t = np.asarray(slam.times) + (slam._epoch or 0.0)
        est_p = slam.front_positions_np()
        ia, ib = metrics.associate_by_time(est_t, gt_t, max_diff=0.05)
        if len(ia) >= 3:
            res.ate_frontend = metrics.ate(est_p[ia], gt_p[ib])
            res.rpe_frontend = metrics.rpe(est_p[ia], gt_p[ib])
        kt, kp, kq = slam.keyframe_trajectory()
        ia, ib = metrics.associate_by_time(np.asarray(kt) + (slam._epoch or 0.0), gt_t,
                                           max_diff=0.05)
        if len(ia) >= 3:
            res.ate_keyframes = metrics.ate(kp[ia], gt_p[ib])
            # z residual and roll/pitch after the same SE(3) alignment the
            # ATE uses: what the ground priors exist to improve
            rot_a, trans_a, _ = metrics.umeyama_alignment(kp[ia], gt_p[ib])
            est_aligned = kp[ia] @ rot_a.T + trans_a
            res.ate_keyframes_z_rmse = float(
                np.sqrt(np.mean((est_aligned[:, 2] - gt_p[ib][:, 2]) ** 2)))
            if gt_rots and kq.shape[0] == kp.shape[0]:
                r_est = so3.quat_to_matrix(torch.as_tensor(kq[ia])).numpy()
                r_gt = np.stack([gt_rots[j] for j in ib])
                rel = np.einsum("nji,njk->nik", r_gt, rot_a[None] @ r_est)
                roll = np.arctan2(rel[:, 2, 1], rel[:, 2, 2])
                pitch = np.arcsin(np.clip(-rel[:, 2, 0], -1.0, 1.0))
                res.ate_keyframes_rp_rmse = float(np.sqrt(np.mean(roll**2 + pitch**2)))

    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        slam.save_results(out_dir)
        if gt_pos:
            quats = np.tile(np.array([1.0, 0, 0, 0]), (len(gt_pos), 1))
            rio.write_tum(os.path.join(out_dir, "gt_tum.txt"), gt_times, np.asarray(gt_pos), quats)
        with open(os.path.join(out_dir, "result.json"), "w") as f:
            json.dump(res.to_json(), f, indent=2)
    return res


# ---------------------------------------------------------------------------
# Scan sources
# ---------------------------------------------------------------------------


class _Frame:
    __slots__ = ("stamp", "points", "ring", "rel_time", "gt_trans")

    def __init__(self, stamp, points, ring=None, rel_time=None, gt_trans=None):
        self.stamp = stamp
        self.points = points
        self.ring = ring
        self.rel_time = rel_time
        self.gt_trans = gt_trans


def frames_from_dir(path: str, rate_hz: float = 10.0) -> Iterator[_Frame]:
    """KITTI .bin or PCD directory, sorted by filename; stamps synthesized at
    `rate_hz` when the filenames are not timestamps."""
    files = sorted(glob.glob(os.path.join(path, "*.bin")) + glob.glob(os.path.join(path, "*.pcd")))
    if not files:
        raise FileNotFoundError(f"no .bin/.pcd scans under {path}")
    for i, fp in enumerate(files):
        if fp.endswith(".bin"):
            pts = rio.read_kitti_bin(fp)[:, :3]
            ring = None
            rel = None
        else:
            fields = rio.read_pcd(fp)
            pts = np.column_stack([fields["x"], fields["y"], fields["z"]]).astype(np.float32)
            ring = fields.get("ring")
            rel = fields.get("time", fields.get("t"))
            if rel is not None and rel.dtype.kind in "ui":  # Ouster t: nanoseconds
                rel = (rel.astype(np.float64) * 1e-9).astype(np.float32)
        stem = os.path.splitext(os.path.basename(fp))[0]
        # filenames are stamps only when they look like seconds (a fraction
        # or epoch-length digits); KITTI frame indices ("000001") get
        # synthesized stamps, else intervals come out 10x wrong
        if "." in stem or len(stem.lstrip("0") or "0") >= 10:
            try:
                stamp = float(stem)
            except ValueError:
                stamp = i / rate_hz
        else:
            stamp = i / rate_hz
        yield _Frame(stamp, pts, ring=ring, rel_time=rel)


def frames_from_bag(path: str, topic: Optional[str] = None) -> Iterator[_Frame]:
    """PointCloud2 messages from a rosbag v2 through the native reader."""
    from ..cpp import host

    reader = host.BagReader(path)
    conns = reader.connections
    pc2 = [c for c, typ in conns if "PointCloud2" in typ]
    want = topic or (pc2[0] if pc2 else None)
    if want is None:
        raise ValueError(f"no PointCloud2 topics in {path}: {conns}")
    for i in range(len(reader)):
        conn_idx, stamp, _ = reader.message_info(i)
        cname, _ = conns[conn_idx]
        if cname != want:
            continue
        fields = reader.read_pointcloud2(i)
        pts = np.asarray(fields["xyz"], np.float32)
        ring = fields.get("ring")
        rel = fields.get("time")
        if rel is not None and rel.dtype.kind in "ui":
            rel = (rel.astype(np.float64) * 1e-9).astype(np.float32)
        # the PointCloud2 header stamp is the scan time; the bag record time
        # when it is zero
        stamp = fields.get("stamp", 0.0) or stamp
        yield _Frame(stamp, pts, ring=ring, rel_time=rel)


def gt_from_tum(path: str) -> List[Tuple[float, np.ndarray]]:
    t, pos, _ = rio.read_tum(path)
    return list(zip(t.tolist(), pos))


def run_simulated(cfg: RoloConfig, sim_cfg=None, out_dir: Optional[str] = None,
                  with_priors: bool = True, progress_every: int = 0,
                  ground_source: str = "live", device=None) -> SequenceResult:
    """The full pipeline over a simulated sequence (the port's `sim`), its
    frames made on `device` (the card when None): scans, ground input for
    the prior stack, ATE against exact ground truth.

    ground_source: "live" (default) lets the system build its own ground map
    from segmented scans, in the same drifting frame as the estimate;
    "external" hands it the simulator's exact ground map, which is
    inconsistent with a drifting estimate (for plumbing tests only)."""
    from ..sim.dataset import SimConfig, generate_sequence, ground_map_points, make_scene

    sim_cfg = sim_cfg or SimConfig()
    if not with_priors and cfg.prior.enable:
        # the live ground map makes priors self-sufficient: "no priors"
        # must turn the subsystem off, not just withhold a map
        cfg = cfg.replace(prior=dataclasses.replace(cfg.prior, enable=False))
    slam = SlamSystem(cfg, device)
    scene = make_scene(sim_cfg, slam.device)
    if with_priors and cfg.prior.enable and ground_source == "external":
        slam.set_ground_map(ground_map_points(sim_cfg, slam.device, scene))
    return run_frames(slam, generate_sequence(sim_cfg, slam.device, scene), out_dir=out_dir,
                      progress_every=progress_every)
