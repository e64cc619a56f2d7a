"""Shared helpers for the torch-port parity tests (tests/test_torch_*.py).

Inputs are made with numpy from a seed and handed to both packages: the JAX
reference on the CPU and its torch counterpart, whose kernel wrappers take
their plain versions on CPU tensors. Sizes follow the bag fixture's
capacities (tests/fixtures/sim_bag/config.yaml: 1536 feature points, 4096
voxels, a 16-beam sensor at 512 columns) so the XLA:CPU programs stay small.
Each tolerance is stated where it is used.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

torch.set_num_threads(2)  # the suite runs 6 xdist workers

FIXTURE_CONFIG = os.path.join(os.path.dirname(__file__), "fixtures", "sim_bag", "config.yaml")


def small_config():
    """The port's RoloConfig at the fixture's capacities."""
    from rolo_tpu_torch.config import load_config

    return load_config(FIXTURE_CONFIG)


def jax_config():
    from rolo_tpu.config import load_config

    return load_config(FIXTURE_CONFIG)


def small_sim_kwargs(n_scans: int, noise: bool = True) -> dict:
    """The bench's simulator settings, cut to a 16-beam sensor at 512 cols."""
    return dict(n_scans=n_scans, n_cols=512, sensor="velodyne16", period=20.0,
                roughness=1.2, noise_std=0.02 if noise else 0.0,
                dropout=0.05 if noise else 0.0, seed=0)


def lidar_cloud(rng, n, spread=0.5, lo=20.0, hi=50.0):
    """Clustered points at lidar range (the cancellation regime)."""
    return (rng.normal(size=(n, 3)) * spread + rng.uniform(lo, hi, size=(n, 1))).astype(np.float32)


def T(x) -> torch.Tensor:
    """numpy (or a JAX array) -> CPU tensor."""
    return torch.as_tensor(np.array(x))


def rot_err_deg(r1, r2) -> np.ndarray:
    """Angle of r1^T r2 in degrees, batched over leading dims."""
    r1 = np.asarray(r1, np.float64)
    r2 = np.asarray(r2, np.float64)
    cos = (np.trace(np.swapaxes(r1, -1, -2) @ r2, axis1=-2, axis2=-1) - 1) / 2
    return np.degrees(np.arccos(np.clip(cos, -1, 1)))


def jax_sim_frames(n_scans: int, noise: bool = True):
    """The JAX simulator's frames as numpy arrays."""
    from rolo_tpu.sim import SimConfig, generate_sequence

    return list(generate_sequence(SimConfig(**small_sim_kwargs(n_scans, noise))))


@functools.lru_cache(maxsize=None)
def _jax_featurizer(cfg):
    import jax

    from rolo_tpu.pointcloud.cloud import concat_clouds
    from rolo_tpu.pointcloud.features import extract_features
    from rolo_tpu.pointcloud.projection import project_scan

    st = cfg.static

    @jax.jit
    def featurize(scan):
        img = project_scan(scan, cfg.sensor.n_scan, cfg.sensor.horizon_scan,
                           cfg.sensor.lidar_min_range, cfg.sensor.lidar_max_range,
                           cfg.sensor.downsample_rate)
        fc = extract_features(img, cfg.features.edge_threshold, cfg.features.surf_threshold,
                              cfg.features.odometry_surf_leaf_size, st.max_corner_points,
                              st.max_surf_points)
        return concat_clouds(fc.corners, fc.surfaces, st.max_feature_points)

    return featurize


def padded_raw(points, ring, rel_time, cap):
    m = min(len(points), cap)
    xyz = np.zeros((cap, 3), np.float32)
    rg = np.zeros((cap,), np.int32)
    rel = np.zeros((cap,), np.float32)
    mask = np.zeros((cap,), bool)
    xyz[:m], rg[:m], rel[:m], mask[:m] = points[:m], ring[:m], rel_time[:m], True
    return xyz, rg, rel, mask


def jax_features(frames, cfg):
    """JAX featurization of numpy frames -> (xyz [T, N, 3], mask [T, N])."""
    import jax.numpy as jnp

    from rolo_tpu.pointcloud.projection import RawScan

    fz = _jax_featurizer(cfg)
    out = []
    for f in frames:
        raw = padded_raw(np.asarray(f.points), np.asarray(f.ring), np.asarray(f.rel_time),
                         cfg.static.max_raw_points)
        c = fz(RawScan(*(jnp.asarray(a) for a in raw)))
        out.append((np.asarray(c.xyz), np.asarray(c.mask)))
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])


def torch_features(frames, cfg):
    """The port's featurization of frames holding numpy or torch arrays."""
    from rolo_tpu_torch.bench import featurize
    from rolo_tpu_torch.sim.dataset import SimFrame

    out = []
    for f in frames:
        tf = SimFrame(f.stamp, T(f.points), T(f.ring), T(f.rel_time), T(f.gt_rot),
                      T(f.gt_trans))
        c = featurize(tf, cfg)
        out.append((c.xyz.numpy(), c.mask.numpy()))
    return np.stack([o[0] for o in out]), np.stack([o[1] for o in out])


def as_jax_config(cfg_torch_reg):
    """The same RegistrationConfig values as the reference's own class."""
    from rolo_tpu.config import RegistrationConfig

    return RegistrationConfig(**dataclasses.asdict(cfg_torch_reg))


def point_set_match(a, b, tol):
    """Fraction of rows of a [Na, 3] with a row of b [Nb, 3] within tol."""
    if len(a) == 0:
        return 1.0 if len(b) == 0 else 0.0
    d2 = ((a[:, None, :].astype(np.float64) - b[None, :, :]) ** 2).sum(-1)
    return float((d2.min(axis=1) <= tol * tol).mean())
