"""Sequence generation, torch port of `rolo_tpu/sim/dataset.py`: drive the
simulated vehicle and emit scans with exact ground truth, on any device.

`SimConfig` repeats the reference's fields and defaults so a configuration
reads the same in both packages. Noise and dropout come from one
`torch.Generator` seeded from `SimConfig.seed`: the scene and the noise-free
geometry match the JAX simulator, the noise draws do not (jax.random and
torch give different numbers from one seed).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, NamedTuple, Optional

import torch

from .lidar import LidarModel, simulate_scan, velodyne16, velodyne32
from .scene import Scene, default_scene, loop_trajectory_pose


@dataclass(frozen=True)
class SimConfig:
    seed: int = 0
    n_scans: int = 120
    scan_rate_hz: float = 10.0
    n_cols: int = 1024
    sensor: str = "velodyne32"  # velodyne32 | velodyne16
    radius_x: float = 18.0
    radius_y: float = 14.0
    period: float = 60.0
    sensor_height: float = 1.8
    extent: float = 60.0
    roughness: float = 1.0
    n_boxes: int = 14
    n_cyls: int = 24
    noise_std: float = 0.02
    dropout: float = 0.05
    max_range: float = 100.0
    motion_distortion: bool = True


class SimFrame(NamedTuple):
    stamp: float
    points: torch.Tensor  # [M, 3] sensor frame, valid returns only
    ring: torch.Tensor  # [M] int32
    rel_time: torch.Tensor  # [M]
    gt_rot: torch.Tensor  # [3, 3] sensor pose in world at `stamp`
    gt_trans: torch.Tensor  # [3]


def lidar_model(cfg: SimConfig, device) -> LidarModel:
    make = velodyne16 if cfg.sensor == "velodyne16" else velodyne32
    return make(device, max_range=cfg.max_range, noise_std=cfg.noise_std, dropout=cfg.dropout)


def make_scene(cfg: SimConfig, device) -> Scene:
    return default_scene(device, seed=cfg.seed, extent=cfg.extent, n_boxes=cfg.n_boxes,
                         n_cyls=cfg.n_cyls, roughness=cfg.roughness)


def simulate_frame(cfg: SimConfig, scene: Scene, model: LidarModel, index: int,
                   generator: torch.Generator):
    """Raycast scan `index` of the sequence: (SimScan, gt_rot, gt_trans)."""
    dev = model.elev.device
    period_s = 1.0 / cfg.scan_rate_hz
    t0 = torch.tensor(index * period_s, dtype=torch.float32, device=dev)

    def traj(t):
        return loop_trajectory_pose(scene, t, radius_x=cfg.radius_x, radius_y=cfg.radius_y,
                                    period=cfg.period, sensor_height=cfg.sensor_height)

    col_frac = torch.arange(cfg.n_cols, device=dev, dtype=torch.float32) / cfg.n_cols
    if cfg.motion_distortion:
        col_rot, col_trans = traj(t0 + col_frac * period_s)
    else:
        r0, tr0 = traj(t0)
        col_rot, col_trans = r0.expand(cfg.n_cols, 3, 3), tr0.expand(cfg.n_cols, 3)
    scan = simulate_scan(scene, model, col_rot, col_trans, generator, scan_period=period_s)
    gt_rot, gt_trans = traj(t0)
    return scan, gt_rot, gt_trans


def generate_sequence(cfg: SimConfig, device, scene: Optional[Scene] = None) -> Iterator[SimFrame]:
    """Yield cfg.n_scans scans at cfg.scan_rate_hz; ground truth is the
    sensor pose at sweep start."""
    scene = make_scene(cfg, device) if scene is None else scene
    model = lidar_model(cfg, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed)
    for i in range(cfg.n_scans):
        scan, gt_rot, gt_trans = simulate_frame(cfg, scene, model, i, gen)
        m = scan.mask
        yield SimFrame(i * (1.0 / cfg.scan_rate_hz), scan.xyz[m], scan.ring[m], scan.rel_time[m],
                       gt_rot, gt_trans)
