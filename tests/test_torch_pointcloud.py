"""Parity of the port's featurizer with the JAX reference: range-image
projection (with deskew) and LOAM features, compared as point sets (the
feature slot order follows argsorts and may differ on ties)."""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_parity import (T, jax_config, jax_features, jax_sim_frames, padded_raw,
                          point_set_match, small_config, torch_features)

from rolo_tpu.pointcloud import projection as jproj
from rolo_tpu.pointcloud.cloud import PaddedCloud as JCloud, concat_clouds as jconcat

from rolo_tpu_torch.pointcloud import projection as proj
from rolo_tpu_torch.pointcloud.cloud import PaddedCloud, concat_clouds


@pytest.fixture(scope="module")
def frames():
    return jax_sim_frames(2)


@pytest.mark.parametrize("deskew", [False, True])
def test_project_scan_matches_reference(frames, deskew):
    cfg = small_config()
    f = frames[1]
    raw = padded_raw(f.points, f.ring, f.rel_time, cfg.static.max_raw_points)
    args = (cfg.sensor.n_scan, cfg.sensor.horizon_scan, cfg.sensor.lidar_min_range,
            cfg.sensor.lidar_max_range)
    rpy, odt, vel = np.float32([0.01, -0.02, 0.05]), np.float32(0.1), np.float32([0.4, 0.1, 0])
    jkw = dict(deskew_rpy=jnp.asarray(rpy), odom_time_diff=jnp.asarray(odt),
               deskew_vel=jnp.asarray(vel)) if deskew else {}
    tkw = dict(deskew_rpy=T(rpy), odom_time_diff=T(odt), deskew_vel=T(vel)) if deskew else {}
    want = jproj.project_scan(jproj.RawScan(*(jnp.asarray(a) for a in raw)), *args, **jkw)
    got = proj.project_scan(proj.RawScan(*(T(a) for a in raw)), *args, **tkw)
    # a point right on a column boundary may land one column over (atan2
    # ulps): per-ring counts and the images agree but for a handful of pixels
    cnt_diff = np.abs(got.count.numpy() - np.asarray(want.count))
    assert cnt_diff.sum() <= 4
    same_ring = cnt_diff == 0
    m = got.mask.numpy()[same_ring]
    np.testing.assert_array_equal(m, np.asarray(want.mask)[same_ring])
    col_eq = got.col.numpy()[same_ring][m] == np.asarray(want.col)[same_ring][m]
    assert col_eq.mean() > 0.995
    xyz_t = got.xyz.numpy()[same_ring][m][col_eq]
    xyz_j = np.asarray(want.xyz)[same_ring][m][col_eq]
    np.testing.assert_allclose(xyz_t, xyz_j, rtol=0, atol=1e-5)


def test_features_match_reference_as_sets(frames):
    cfg, jcfg = small_config(), jax_config()
    jx, jm = jax_features(frames, jcfg)
    tx, tm = torch_features(frames, cfg)
    for i in range(len(frames)):
        a, b = tx[i][tm[i]], jx[i][jm[i]]
        assert abs(len(a) - len(b)) <= 2
        # corners are raw points, surfaces voxel centroids: same sets, up to
        # the odd point that a boundary pixel moves between sectors/voxels
        assert point_set_match(a, b, 1e-5) > 0.995
        assert point_set_match(b, a, 1e-5) > 0.995


def test_concat_clouds_compacts_like_reference():
    rng = np.random.default_rng(0)
    xa, xb = rng.normal(size=(2, 64, 3)).astype(np.float32)
    ma, mb = rng.random(64) < 0.4, rng.random(64) < 0.7
    for cap in (80, 128, 160):
        want = jconcat(JCloud(jnp.asarray(xa), jnp.asarray(ma)),
                       JCloud(jnp.asarray(xb), jnp.asarray(mb)), cap)
        got = concat_clouds(PaddedCloud(T(xa), T(ma)), PaddedCloud(T(xb), T(mb)), cap)
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
        np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))
