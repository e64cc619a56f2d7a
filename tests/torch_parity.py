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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE_CONFIG = os.path.join(os.path.dirname(__file__), "fixtures", "sim_bag", "config.yaml")


def small_config(**overrides):
    """The port's RoloConfig at the fixture's capacities; `overrides` are
    dotted keys such as {"mapping.mapping_process_interval": 0.15}."""
    from rolo_tpu_torch.config import load_config

    return load_config(FIXTURE_CONFIG, overrides)


def jax_config(**overrides):
    from rolo_tpu.config import load_config

    return load_config(FIXTURE_CONFIG, overrides)


def small_sim_kwargs(n_scans: int, noise: bool = True) -> dict:
    """The bench's simulator settings, cut to a 16-beam sensor at 512 cols."""
    return dict(n_scans=n_scans, n_cols=512, sensor="velodyne16", period=20.0,
                roughness=1.2, noise_std=0.02 if noise else 0.0,
                dropout=0.05 if noise else 0.0, seed=0)


def lidar_cloud(rng, n, spread=0.5, lo=20.0, hi=50.0):
    """Clustered points at lidar range (the cancellation regime)."""
    return (rng.normal(size=(n, 3)) * spread + rng.uniform(lo, hi, size=(n, 1))).astype(np.float32)


def knn_instance(rng, case, n):
    """One K2 test instance: (candidates [n, 3] f32, candidate mask [n])
    of a lidar cloud; "duplicates" rounds the points and repeats 40 of them
    (ties at the k-th place), "starved" leaves 6 valid candidates,
    "all_masked" none."""
    cand = lidar_cloud(rng, n)
    cmask = rng.random(n) < 0.9
    if case == "duplicates":
        cand = np.round(cand * 4) / 4
        cand[n // 3:n // 3 + 40] = cand[:40]
    elif case == "starved":
        cmask = np.zeros(n, bool)
        cmask[rng.choice(n, 6, replace=False)] = True
    elif case == "all_masked":
        cmask = np.zeros(n, bool)
    return cand.astype(np.float32), cmask


# (case, N) of the K2 tests: N < k, N not a multiple of the kernel's
# 64-candidate tile
KNN_CASES = [("lidar", 300), ("duplicates", 257), ("starved", 200), ("all_masked", 128),
             ("lidar", 12), ("lidar", 131)]


def knn_batch(case, n, k):
    """Two instances (the case, and a lidar instance beside it) as CPU
    tensors (xyz, mask, cand, cmask) with every fifth query masked and
    masked coordinates zeroed, as estimate_cov6 hands them to K2."""
    rng = np.random.default_rng(n * 100 + k)
    inst = [knn_instance(rng, case, n), knn_instance(rng, "lidar", n)]
    cmask = torch.tensor(np.stack([m for _, m in inst]))
    cand = torch.where(cmask[..., None], torch.tensor(np.stack([c for c, _ in inst])), 0.0)
    q = max(1, n // 2)
    mask = cmask[:, :q].clone()
    mask[:, ::5] = False
    xyz = torch.where(mask[..., None], cand[:, :q], 0.0).contiguous()
    return xyz, mask, cand.contiguous(), cmask


def T(x) -> torch.Tensor:
    """numpy (or a JAX array) -> CPU tensor."""
    return torch.as_tensor(np.array(x))


def rot_err_deg(r1, r2) -> np.ndarray:
    """Angle of r1^T r2 in degrees, batched over leading dims."""
    r1 = np.asarray(r1, np.float64)
    r2 = np.asarray(r2, np.float64)
    cos = (np.trace(np.swapaxes(r1, -1, -2) @ r2, axis1=-2, axis2=-1) - 1) / 2
    return np.degrees(np.arccos(np.clip(cos, -1, 1)))


def rot_diff_rad(r1, r2) -> np.ndarray:
    """Rotation angle of r1^T r2 in radians from its antisymmetric part,
    accurate near zero where the trace form bottoms out at ~1e-4 rad for
    f32 matrices."""
    r1 = np.asarray(r1, np.float64)
    r2 = np.asarray(r2, np.float64)
    m = np.swapaxes(r1, -1, -2) @ r2
    v = np.stack([m[..., 2, 1] - m[..., 1, 2], m[..., 0, 2] - m[..., 2, 0],
                  m[..., 1, 0] - m[..., 0, 1]], axis=-1) / 2
    return np.arcsin(np.clip(np.linalg.norm(v, axis=-1), 0.0, 1.0))


def jax_sim_frames(n_scans: int, noise: bool = True):
    """The JAX simulator's frames as numpy arrays."""
    from rolo_tpu.sim import SimConfig, generate_sequence

    return list(generate_sequence(SimConfig(**small_sim_kwargs(n_scans, noise))))


@functools.lru_cache(maxsize=None)
def _jax_featurizer(cfg):
    import jax

    from rolo_tpu.pointcloud.cloud import PaddedCloud, concat_clouds
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
        raw = PaddedCloud(img.xyz.reshape(-1, 3), img.mask.reshape(-1))
        return concat_clouds(fc.corners, fc.surfaces, st.max_feature_points), fc, raw

    return featurize


def padded_raw(points, ring, rel_time, cap):
    m = min(len(points), cap)
    xyz = np.zeros((cap, 3), np.float32)
    rg = np.zeros((cap,), np.int32)
    rel = np.zeros((cap,), np.float32)
    mask = np.zeros((cap,), bool)
    xyz[:m], rg[:m], rel[:m], mask[:m] = points[:m], ring[:m], rel_time[:m], True
    return xyz, rg, rel, mask


def jax_feature_parts(frames, cfg):
    """JAX featurization of numpy frames, per frame: (stacked feature cloud,
    FeatureClouds, the range image's points as one PaddedCloud), numpy."""
    import jax
    import jax.numpy as jnp

    from rolo_tpu.pointcloud.projection import RawScan

    fz = _jax_featurizer(cfg)
    out = []
    for f in frames:
        raw = padded_raw(np.asarray(f.points), np.asarray(f.ring), np.asarray(f.rel_time),
                         cfg.static.max_raw_points)
        out.append(jax.tree_util.tree_map(np.asarray, fz(RawScan(*(jnp.asarray(a) for a in raw)))))
    return out


def jax_features(frames, cfg):
    """JAX featurization of numpy frames -> (xyz [T, N, 3], mask [T, N])."""
    parts = jax_feature_parts(frames, cfg)
    return np.stack([p[0].xyz for p in parts]), np.stack([p[0].mask for p in parts])


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


def port_config(jcfg):
    """The port's RoloConfig with the values of a JAX package RoloConfig
    (each package has its own copy of the same dataclasses)."""
    from rolo_tpu_torch import config as pc

    def convert(value):
        if dataclasses.is_dataclass(value):
            cls = getattr(pc, type(value).__name__)
            return cls(**{f.name: convert(getattr(value, f.name))
                          for f in dataclasses.fields(value)})
        return value

    return convert(jcfg)


def structured_world(seed=0):
    """tests/test_backend.py's structured world (:39-59), the same draws:
    vertical corner lines, a ground plane at z = -1.5 and two walls, as
    numpy (corner points, surface points)."""
    rng = np.random.default_rng(seed)
    corners = []
    for cx, cy in [(5, 5), (10, -4), (16, 6), (22, -5), (28, 4), (3, -6), (14, 1), (25, 8)]:
        z = rng.uniform(-1, 2, (60, 1))
        pts = np.column_stack([np.full((60, 1), float(cx)), np.full((60, 1), float(cy)), z])
        corners.append(pts + rng.normal(0, 0.01, pts.shape))
    surfs = []
    gxy = rng.uniform([-5, -10], [35, 10], (900, 2))
    surfs.append(np.column_stack([gxy, np.full(900, -1.5) + rng.normal(0, 0.01, 900)]))
    wx = rng.uniform(-5, 35, 400)
    wz = rng.uniform(-1, 2.5, 400)
    surfs.append(np.column_stack([wx, np.full(400, 8.0) + rng.normal(0, 0.01, 400), wz]))
    surfs.append(np.column_stack([wx, np.full(400, -8.0) + rng.normal(0, 0.01, 400), wz]))
    return np.concatenate(corners).astype(np.float32), np.concatenate(surfs).astype(np.float32)


def _out_and_back_scans(corner_cap, surf_cap, drift, n_out, n_back):
    """Per keyframe: (stored translation, corner points, surface points) in
    the sensor frame (identity rotation), within 25 m of the sensor."""
    corner_w, surf_w = structured_world()
    xs = list(np.linspace(0, 6, n_out)) + list(np.linspace(6, 0.2, n_back))
    out = []
    for i, x in enumerate(xs):
        trans = np.array([x, 0.0, 0.0], np.float32)

        def local(world, cap):
            pts = world - trans
            return pts[np.linalg.norm(pts, axis=1) < 25.0][:cap]

        stored = trans + np.float32(i) * np.asarray(drift, np.float32)
        out.append((stored, local(corner_w, corner_cap), local(surf_w, surf_cap)))
    return out


def out_and_back(jcfg, drift=(0.0, 0.03, 0.0), n_out=7, n_back=7):
    """A JAX BackendState on the structured world: keyframes every metre
    out along x and back (stamps 0, 1, 2, ... s), each stored at its true
    pose plus `drift` per keyframe, with their clouds, scan-context
    descriptors and odometry factors, built with add_keyframe (no
    scan-to-map step). `port_out_and_back` builds the same in the port."""
    import jax.numpy as jnp

    from rolo_tpu.geometry.se3 import SE3
    from rolo_tpu.loop import scancontext as jsc
    from rolo_tpu.mapping import backend as jbk
    from rolo_tpu.mapping.keyframes import add_keyframe
    from rolo_tpu.pointcloud.cloud import PaddedCloud as JCloud

    st, lc = jcfg.static, jcfg.loop
    state = jbk.init_backend(jcfg)
    db, scdb = state.db, state.scdb
    scans = _out_and_back_scans(st.max_corner_points, st.max_surf_points, drift, n_out, n_back)
    for i, (stored, corner, surf) in enumerate(scans):
        c = JCloud.from_points(corner, st.max_corner_points)
        s = JCloud.from_points(surf, st.max_surf_points)
        db = add_keyframe(db, SE3(jnp.eye(3), jnp.asarray(stored)), jnp.asarray(float(i)), c, s)
        scdb = jsc.add_descriptor(scdb, jsc.make_descriptor(
            s.xyz, s.mask, lc.sc_num_ring, lc.sc_num_sector, lc.sc_max_radius,
            lc.sc_lidar_height))
    odom = np.asarray(state.graph.odom_rel_trans).copy()
    for k in range(1, len(scans)):
        odom[k] = scans[k][0] - scans[k - 1][0]
    graph = state.graph._replace(first_trans=jnp.asarray(scans[0][0]),
                                 odom_rel_trans=jnp.asarray(odom))
    return state._replace(db=db, scdb=scdb, graph=graph, xyz=jnp.asarray(scans[-1][0]))


def port_out_and_back(cfg, device, drift=(0.0, 0.03, 0.0), n_out=7, n_back=7):
    """`out_and_back` in the port, on `device`, without JAX."""
    from rolo_tpu_torch.geometry.se3 import SE3
    from rolo_tpu_torch.loop import scancontext as sc
    from rolo_tpu_torch.mapping import backend as bk
    from rolo_tpu_torch.mapping.keyframes import add_keyframe
    from rolo_tpu_torch.pointcloud.cloud import PaddedCloud

    st, lc = cfg.static, cfg.loop
    state = bk.init_backend(cfg, device)
    db, scdb = state.db, state.scdb
    scans = _out_and_back_scans(st.max_corner_points, st.max_surf_points, drift, n_out, n_back)
    eye = torch.eye(3, device=device)
    for i, (stored, corner, surf) in enumerate(scans):
        c = PaddedCloud.from_points(corner, st.max_corner_points, device)
        s = PaddedCloud.from_points(surf, st.max_surf_points, device)
        db = add_keyframe(db, SE3(eye, torch.as_tensor(stored, device=device)), float(i), c, s)
        scdb = sc.add_descriptor(scdb, sc.make_descriptor(
            s.xyz, s.mask, lc.sc_num_ring, lc.sc_num_sector, lc.sc_max_radius,
            lc.sc_lidar_height))
    graph = state.graph
    for k in range(1, len(scans)):
        graph.odom_rel_trans[k] = torch.as_tensor(scans[k][0] - scans[k - 1][0])
    graph = graph._replace(first_trans=torch.as_tensor(scans[0][0], device=device))
    return state._replace(db=db, scdb=scdb, graph=graph,
                          xyz=torch.as_tensor(scans[-1][0], device=device))


def loop_test_config(kind="all"):
    """The port's config for the out-and-back loop scenarios: the fixture's
    capacities with tests/test_backend.py's SMALL loop settings."""
    return small_config(**{"loop.enable": True, "loop.loop_close_type": kind,
                           "loop.history_search_radius": 5.0,
                           "loop.history_search_time_diff": 3.0, "loop.history_search_num": 2,
                           "loop.history_fitness_score": 0.3, "loop.sc_num_exclude_recent": 3})
