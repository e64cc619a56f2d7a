"""Analytic world model, torch port of `rolo_tpu/sim/scene.py`: a terrain
heightfield of sinusoids, axis-aligned boxes, vertical cylinders, and an
elliptical vehicle loop on the terrain. `default_scene` draws the scene with
numpy's RNG exactly as the reference does, so both packages see one world.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..geometry import so3


class Scene(NamedTuple):
    terrain_amp: torch.Tensor  # [T]
    terrain_fx: torch.Tensor
    terrain_fy: torch.Tensor
    terrain_phase: torch.Tensor
    box_min: torch.Tensor  # [Bx, 3]
    box_max: torch.Tensor
    cyl_xy: torch.Tensor  # [C, 2]
    cyl_r: torch.Tensor  # [C]
    cyl_z0: torch.Tensor
    cyl_z1: torch.Tensor


def terrain_height(scene: Scene, xy: torch.Tensor) -> torch.Tensor:
    """z of the terrain at xy [..., 2]."""
    x, y = xy[..., 0:1], xy[..., 1:2]
    return torch.sum(
        scene.terrain_amp
        * torch.sin(scene.terrain_fx * x + scene.terrain_fy * y + scene.terrain_phase), dim=-1)


def terrain_slope(scene: Scene, xy: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    x, y = xy[..., 0:1], xy[..., 1:2]
    c = scene.terrain_amp * torch.cos(
        scene.terrain_fx * x + scene.terrain_fy * y + scene.terrain_phase)
    return torch.sum(c * scene.terrain_fx, dim=-1), torch.sum(c * scene.terrain_fy, dim=-1)


def default_scene(device, seed: int = 0, extent: float = 60.0, n_boxes: int = 14,
                  n_cyls: int = 24, roughness: float = 1.0) -> Scene:
    """The reference's bounded outdoor scene (scene.py:57-118), same draws."""
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


def loop_trajectory_pose(scene: Scene, t: torch.Tensor, *, radius_x: float = 18.0,
                         radius_y: float = 14.0, period: float = 60.0,
                         sensor_height: float = 1.8) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sensor pose (rot [..., 3, 3], trans [..., 3]) at times t on the
    terrain-following ellipse loop (scene.py:121-157)."""
    w = 2.0 * math.pi / period
    x = radius_x * torch.cos(w * t)
    y = radius_y * torch.sin(w * t)
    vx = -radius_x * w * torch.sin(w * t)
    vy = radius_y * w * torch.cos(w * t)
    yaw = torch.atan2(vy, vx)
    xy = torch.stack([x, y], dim=-1)
    z = terrain_height(scene, xy) + sensor_height
    gx, gy = terrain_slope(scene, xy)
    cy_, sy_ = torch.cos(yaw), torch.sin(yaw)
    pitch = -torch.atan(gx * cy_ + gy * sy_)
    roll = torch.atan(-gx * sy_ + gy * cy_)
    return so3.rpy_to_matrix(roll, pitch, yaw), torch.stack([x, y, z], dim=-1)
