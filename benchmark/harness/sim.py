"""The benchmark's simulated worlds and sensors.

Frozen copy of `rolo_tpu_torch/sim/scene.py` (scene draws, terrain,
trajectory), `rolo_tpu_torch/sim/lidar.py` (the raycaster),
`rolo_tpu_torch/geometry/so3.py`'s `rpy_to_matrix`, and the 64-beam
`ouster_model` of `chip_smoke.py`, as of commit fba7730. The copy lives
here so that a change to the program cannot move the yardstick. One
departure: `raycast` casts several scans in one call (the rays of all of
them at once), which shortens set-up; its noise is drawn per call from the
run's generator, so a seed gives the same scans on every run.

A sensor comes from the configuration's file (beams, elevations, columns,
ring order), a world from the traffic's file.
"""

from __future__ import annotations

import math
from typing import Dict, List, NamedTuple

import numpy as np
import torch


class Scene(NamedTuple):
    terrain_amp: torch.Tensor
    terrain_fx: torch.Tensor
    terrain_fy: torch.Tensor
    terrain_phase: torch.Tensor
    box_min: torch.Tensor
    box_max: torch.Tensor
    cyl_xy: torch.Tensor
    cyl_r: torch.Tensor
    cyl_z0: torch.Tensor
    cyl_z1: torch.Tensor


class Scan(NamedTuple):
    """One scan as a driver hands it over, in host memory."""

    stamp: float
    xyz: np.ndarray  # [M, 3] f32, sensor frame, valid returns only
    ring: np.ndarray  # [M] int32, in the driver's ring order
    rel_time: np.ndarray  # [M] f32, s from the sweep's start
    gt_rot: np.ndarray  # [3, 3] f64, sensor pose in the world at the sweep's start
    gt_trans: np.ndarray  # [3] f64


def rpy_to_matrix(roll, pitch, yaw) -> torch.Tensor:
    cr, sr = torch.cos(roll), torch.sin(roll)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    row0 = torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1)
    row1 = torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1)
    row2 = torch.stack([-sp, cp * sr, cp * cr], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def terrain_height(scene: Scene, xy: torch.Tensor) -> torch.Tensor:
    x, y = xy[..., 0:1], xy[..., 1:2]
    return torch.sum(
        scene.terrain_amp
        * torch.sin(scene.terrain_fx * x + scene.terrain_fy * y + scene.terrain_phase), dim=-1)


def terrain_slope(scene: Scene, xy: torch.Tensor):
    x, y = xy[..., 0:1], xy[..., 1:2]
    c = scene.terrain_amp * torch.cos(
        scene.terrain_fx * x + scene.terrain_fy * y + scene.terrain_phase)
    return torch.sum(c * scene.terrain_fx, dim=-1), torch.sum(c * scene.terrain_fy, dim=-1)


def make_scene(seed: int, device, extent: float = 60.0, n_boxes: int = 14, n_cyls: int = 24,
               roughness: float = 1.0) -> Scene:
    """The bounded outdoor scene, drawn with numpy's generator from `seed`."""
    rng = np.random.default_rng(seed)
    n_terms = 6
    wavelength = rng.uniform(25.0, 80.0, n_terms)
    amp = roughness * rng.uniform(0.2, 0.9, n_terms) * (wavelength / 80.0)
    ang = rng.uniform(0, 2 * np.pi, n_terms)
    freq = 2 * np.pi / wavelength
    fx, fy = freq * np.cos(ang), freq * np.sin(ang)
    phase = rng.uniform(0, 2 * np.pi, n_terms)

    def h(x, y):
        return np.sum(amp * np.sin(fx * x + fy * y + phase))

    boxes_min, boxes_max = [], []
    for _ in range(n_boxes):
        r = rng.uniform(26.0, extent)
        th = rng.uniform(0, 2 * np.pi)
        cx, cy = r * np.cos(th), r * np.sin(th)
        sx, sy = rng.uniform(2.0, 8.0, 2)
        hgt = rng.uniform(2.5, 7.0)
        z0 = h(cx, cy) - 0.5
        boxes_min.append([cx - sx / 2, cy - sy / 2, z0])
        boxes_max.append([cx + sx / 2, cy + sy / 2, z0 + hgt])

    cyl_xy, cyl_r, cyl_z0, cyl_z1 = [], [], [], []
    for _ in range(n_cyls):
        r = rng.uniform(5.0, extent)
        th = rng.uniform(0, 2 * np.pi)
        cx, cy = r * np.cos(th), r * np.sin(th)
        if 10.0 < np.hypot(cx, cy) < 24.0:
            cx *= 26.0 / max(np.hypot(cx, cy), 1e-3)
            cy *= 26.0 / max(np.hypot(cx, cy), 1e-3)
        z0 = h(cx, cy) - 0.2
        cyl_xy.append([cx, cy])
        cyl_r.append(rng.uniform(0.15, 0.5))
        cyl_z0.append(z0)
        cyl_z1.append(z0 + rng.uniform(2.0, 6.0))

    def t(a, shape=None):
        arr = np.asarray(a, np.float32)
        return torch.as_tensor(arr if shape is None else arr.reshape(shape), device=device)

    return Scene(t(amp), t(fx), t(fy), t(phase), t(boxes_min, (-1, 3)), t(boxes_max, (-1, 3)),
                 t(cyl_xy, (-1, 2)), t(cyl_r), t(cyl_z0), t(cyl_z1))


def trajectory_pose(scene: Scene, t: torch.Tensor, world: Dict):
    """Sensor pose (rot [..., 3, 3], trans [..., 3]) at times t on the
    terrain-following ellipse loop."""
    w = 2.0 * math.pi / world["period"]
    rx, ry = world["radius_x"], world["radius_y"]
    x = rx * torch.cos(w * t)
    y = ry * torch.sin(w * t)
    vx = -rx * w * torch.sin(w * t)
    vy = ry * w * torch.cos(w * t)
    yaw = torch.atan2(vy, vx)
    xy = torch.stack([x, y], dim=-1)
    z = terrain_height(scene, xy) + world["sensor_height"]
    gx, gy = terrain_slope(scene, xy)
    cy_, sy_ = torch.cos(yaw), torch.sin(yaw)
    pitch = -torch.atan(gx * cy_ + gy * sy_)
    roll = torch.atan(-gx * sy_ + gy * cy_)
    return rpy_to_matrix(roll, pitch, yaw), torch.stack([x, y, z], dim=-1)


def _ray_boxes(scene: Scene, o, d):
    if scene.box_min.shape[0] == 0:
        return torch.full(o.shape[:1], float("inf"), device=o.device)
    tiny = torch.where(d >= 0, 1e-9, -1e-9)
    inv = 1.0 / torch.where(torch.abs(d) < 1e-9, tiny, d)
    t1 = (scene.box_min[None] - o[:, None]) * inv[:, None]
    t2 = (scene.box_max[None] - o[:, None]) * inv[:, None]
    tn = torch.amax(torch.minimum(t1, t2), dim=-1)
    tf = torch.amin(torch.maximum(t1, t2), dim=-1)
    hit = (tf >= torch.clamp(tn, min=1e-3)) & (tn > 1e-3)
    return torch.amin(torch.where(hit, tn, float("inf")), dim=-1)


def _ray_cylinders(scene: Scene, o, d):
    if scene.cyl_xy.shape[0] == 0:
        return torch.full(o.shape[:1], float("inf"), device=o.device)
    oc = o[:, None, :2] - scene.cyl_xy[None]
    dd = d[:, None, :2]
    a = torch.sum(dd * dd, dim=-1)
    b = 2.0 * torch.sum(oc * dd, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - scene.cyl_r[None] ** 2
    disc = b * b - 4 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t = (-b - sq) / torch.clamp(2 * a, min=1e-9)
    z = o[:, None, 2] + t * d[:, None, 2]
    hit = (disc > 0) & (t > 1e-3) & (z >= scene.cyl_z0[None]) & (z <= scene.cyl_z1[None])
    return torch.amin(torch.where(hit, t, float("inf")), dim=-1)


def _ray_terrain(scene: Scene, o, d, max_range: float, n_march: int = 160, n_bisect: int = 14):
    ts = torch.linspace(0.5, max_range, n_march, device=o.device)
    dt = ts[1] - ts[0]

    def above(t):
        p_xy = o[:, :2] + t[:, None] * d[:, :2]
        return o[:, 2] + t * d[:, 2] - terrain_height(scene, p_xy)

    r = o.shape[0]
    inf = torch.full((r,), float("inf"), device=o.device)
    t_lo, t_hi = inf, inf
    found = torch.zeros(r, dtype=torch.bool, device=o.device)
    f_prev = above(torch.full((r,), 1e-3, device=o.device))
    for k in range(n_march):
        t_k = ts[k]
        f_k = above(t_k.expand(r))
        crossing = (f_prev > 0) & (f_k <= 0) & ~found
        t_lo = torch.where(crossing, t_k - dt, t_lo)
        t_hi = torch.where(crossing, t_k, t_hi)
        found = found | crossing
        f_prev = f_k
    lo = torch.where(found, t_lo, 1.0)
    hi = torch.where(found, t_hi, 2.0)
    for _ in range(n_bisect):
        mid = 0.5 * (lo + hi)
        f_mid = above(torch.where(found, mid, 1.0))
        lo = torch.where(f_mid > 0, mid, lo)
        hi = torch.where(f_mid > 0, hi, mid)
    return torch.where(found, 0.5 * (lo + hi), float("inf"))


def elevations(sensor: Dict) -> np.ndarray:
    """The beams' elevations in rad, top beam first."""
    return np.linspace(sensor["elev_top_deg"], sensor["elev_bottom_deg"],
                       sensor["beams"]) * np.pi / 180.0


def raycast(scene: Scene, sensor: Dict, world: Dict, indices: List[int],
            generator: torch.Generator) -> List[Scan]:
    """Scans `indices` of the sequence, all in one call: each column is cast
    from the sensor pose at its own capture time (motion distortion), range
    noise and dropout drawn from `generator`. Rings are numbered as the
    sensor's driver numbers them (`ring_order`)."""
    dev = scene.terrain_amp.device
    n_beams, n_cols = sensor["beams"], sensor["cols"]
    period_s = 1.0 / world["scan_rate_hz"]
    idx = torch.as_tensor(indices, dtype=torch.float32, device=dev)
    t0 = idx * period_s
    cols = torch.arange(n_cols, device=dev, dtype=torch.float32)
    col_frac = cols / n_cols
    if world["motion_distortion"]:
        col_rot, col_trans = trajectory_pose(scene, t0[:, None] + col_frac[None] * period_s, world)
    else:
        r0, tr0 = trajectory_pose(scene, t0, world)
        col_rot = r0[:, None].expand(len(indices), n_cols, 3, 3)
        col_trans = tr0[:, None].expand(len(indices), n_cols, 3)
    elev = torch.as_tensor(elevations(sensor).astype(np.float32), device=dev)
    az = -2.0 * math.pi * cols / n_cols
    ce, se = torch.cos(elev), torch.sin(elev)
    ca, sa = torch.cos(az), torch.sin(az)
    d_sensor = torch.stack([ce[:, None] * ca[None, :], ce[:, None] * sa[None, :],
                            se[:, None].expand(n_beams, n_cols)], dim=-1)  # [beams, cols, 3]
    # [S, beams, cols, 3], the column's rotation applied elementwise (no matmul)
    d_world = (col_rot[:, None] * d_sensor[None, :, :, None, :]).sum(-1)
    o = col_trans[:, None].expand(len(indices), n_beams, n_cols, 3).reshape(-1, 3)
    d = d_world.reshape(-1, 3)
    t = torch.minimum(torch.minimum(_ray_boxes(scene, o, d), _ray_cylinders(scene, o, d)),
                      _ray_terrain(scene, o, d, sensor["max_range"]))
    noise = torch.randn(t.shape, generator=generator, device=dev)
    drop = torch.rand(t.shape, generator=generator, device=dev)
    t = t + world["noise_std"] * noise
    valid = (torch.isfinite(t) & (t >= sensor["min_range"]) & (t <= sensor["max_range"])
             & (drop >= world["dropout"]))
    xyz = torch.where(valid, t, 1.0)[:, None] * d_sensor.reshape(1, -1, 3).expand(
        len(indices), -1, 3).reshape(-1, 3)
    beam = torch.arange(n_beams, dtype=torch.int32, device=dev)
    ring = beam if sensor["ring_order"] == "top_first" else n_beams - 1 - beam
    ring = ring[:, None].expand(n_beams, n_cols).reshape(-1)
    rel_time = (period_s * cols / n_cols)[None].expand(n_beams, n_cols).reshape(-1)
    gt_rot, gt_trans = trajectory_pose(scene, t0, world)
    per = n_beams * n_cols
    xyz_h = xyz.reshape(len(indices), per, 3).cpu().numpy()
    valid_h = valid.reshape(len(indices), per).cpu().numpy()
    ring_h, rel_h = ring.cpu().numpy(), rel_time.cpu().numpy()
    gr, gtr = gt_rot.double().cpu().numpy(), gt_trans.double().cpu().numpy()
    out = []
    for j, i in enumerate(indices):
        m = valid_h[j]
        out.append(Scan(i * period_s, np.ascontiguousarray(xyz_h[j][m]), ring_h[m].copy(),
                        rel_h[m].copy(), gr[j], gtr[j]))
    return out


def sequence(seed: int, sensor: Dict, world: Dict, n_scans: int, device,
             max_rays: int = 1 << 20, scene_seed: int = None) -> List[Scan]:
    """n_scans scans, raycast on `device` in calls of at most `max_rays`
    rays: the scene drawn from `scene_seed` (the world's own `scene_seed`
    when not given), the range noise and dropout from `seed`. A fixed scene
    gives every seed the same work, in other noise."""
    scene_seed = world["scene_seed"] if scene_seed is None else scene_seed
    scene = make_scene(scene_seed, device, world["extent"], world["n_boxes"], world["n_cyls"],
                       world["roughness"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    per_call = max(1, max_rays // (sensor["beams"] * sensor["cols"]))
    scans: List[Scan] = []
    for s0 in range(0, n_scans, per_call):
        scans += raycast(scene, sensor, world, list(range(s0, min(n_scans, s0 + per_call))), gen)
    return scans


def relative_truth(scans: List[Scan]) -> np.ndarray:
    """[T, 3] f64: each scan's true position in the first scan's sensor
    frame, where the SLAM system puts its origin."""
    r0, t0 = scans[0].gt_rot, scans[0].gt_trans
    return np.stack([r0.T @ (s.gt_trans - t0) for s in scans])
