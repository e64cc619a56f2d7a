"""Spinning multi-beam LiDAR raycaster, torch port of `rolo_tpu/sim/lidar.py`.

One scan is [n_beams, n_cols] rays against the analytic scene: slab-tested
boxes, quadratic cylinders, and a marched + bisected terrain heightfield,
each column cast from the sensor pose at its own capture time (motion
distortion). Range noise and dropout come from a `torch.Generator`.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from .scene import Scene, terrain_height


class LidarModel(NamedTuple):
    elev: torch.Tensor  # [n_beams] rad, top first (ring 0 = highest beam)
    min_range: float
    max_range: float
    noise_std: float
    dropout: float


def velodyne32(device, min_range: float = 1.0, max_range: float = 100.0,
               noise_std: float = 0.02, dropout: float = 0.05) -> LidarModel:
    elev = np.linspace(10.67, -30.67, 32) * np.pi / 180.0
    return LidarModel(torch.as_tensor(elev.astype(np.float32), device=device), min_range,
                      max_range, noise_std, dropout)


def velodyne16(device, min_range: float = 1.0, max_range: float = 80.0,
               noise_std: float = 0.02, dropout: float = 0.05) -> LidarModel:
    elev = np.linspace(15.0, -15.0, 16) * np.pi / 180.0
    return LidarModel(torch.as_tensor(elev.astype(np.float32), device=device), min_range,
                      max_range, noise_std, dropout)


class SimScan(NamedTuple):
    xyz: torch.Tensor  # [n_beams * n_cols, 3] sensor frame
    ring: torch.Tensor  # int32
    rel_time: torch.Tensor
    mask: torch.Tensor


def _ray_boxes(scene: Scene, o, d):
    """Nearest box hit per ray, +inf when none (lidar.py:57-67)."""
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
    """Nearest vertical-cylinder hit per ray, +inf when none (lidar.py:70-85)."""
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


def _ray_terrain(scene: Scene, o, d, max_range: float, n_march: int = 160,
                 n_bisect: int = 14):
    """First terrain crossing per ray: fixed-step march, then bisection of
    the bracket (lidar.py:88-126)."""
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


def simulate_scan(scene: Scene, model: LidarModel, col_rot: torch.Tensor,
                  col_trans: torch.Tensor, generator: torch.Generator,
                  scan_period: float = 0.1) -> SimScan:
    """One 360-degree sweep (lidar.py:129-179). col_rot [n_cols, 3, 3] and
    col_trans [n_cols, 3] are the sensor pose of each azimuth column."""
    dev = col_rot.device
    n_beams = model.elev.shape[0]
    n_cols = col_rot.shape[0]
    cols = torch.arange(n_cols, device=dev, dtype=torch.float32)
    az = -2.0 * math.pi * cols / n_cols
    ce, se = torch.cos(model.elev), torch.sin(model.elev)
    ca, sa = torch.cos(az), torch.sin(az)
    d_sensor = torch.stack(
        [ce[:, None] * ca[None, :], ce[:, None] * sa[None, :], se[:, None].expand(n_beams, n_cols)],
        dim=-1)
    d_world = torch.einsum("cij,bcj->bci", col_rot, d_sensor)
    o = col_trans[None].expand(n_beams, n_cols, 3).reshape(-1, 3)
    d = d_world.reshape(-1, 3)

    t = torch.minimum(torch.minimum(_ray_boxes(scene, o, d), _ray_cylinders(scene, o, d)),
                      _ray_terrain(scene, o, d, model.max_range))
    noise = torch.randn(t.shape, generator=generator, device=dev)
    drop = torch.rand(t.shape, generator=generator, device=dev)
    t = t + model.noise_std * noise
    valid = torch.isfinite(t) & (t >= model.min_range) & (t <= model.max_range) & \
        (drop >= model.dropout)
    xyz = torch.where(valid, t, 1.0)[:, None] * d_sensor.reshape(-1, 3)
    ring = torch.arange(n_beams, dtype=torch.int32, device=dev)[:, None].expand(n_beams, n_cols)
    rel_time = (scan_period * cols / n_cols)[None].expand(n_beams, n_cols)
    return SimScan(xyz, ring.reshape(-1), rel_time.reshape(-1), valid)
