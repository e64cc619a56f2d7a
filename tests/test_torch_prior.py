"""The ground-prior stack of the port against the JAX reference on the same
inputs: ground-map queries, the live ground map and its numpy bridge, ground
segmentation (with the reference's column-0 fault shown beside the port's
repair), the wheel-contact solver on planes and on the simulator's terrain,
prior observations, the prior queue, association, and the back-end's
prior_step / record_prior_observation gates."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_parity import T, jax_sim_frames, padded_raw, port_config, rot_diff_rad, small_config
from test_backend import SMALL, TestPriorStep, _se3

from rolo_tpu.config import PriorConfig as JPriorConfig
from rolo_tpu.mapping import backend as jbk
from rolo_tpu.mapping.keyframes import add_keyframe as j_add_keyframe
from rolo_tpu.pointcloud.cloud import PaddedCloud as JCloud
from rolo_tpu.pointcloud.ground_seg import segment_ground as j_segment_ground
from rolo_tpu.pointcloud.projection import RawScan as JRawScan
from rolo_tpu.pointcloud.projection import RingImage as JRingImage
from rolo_tpu.pointcloud.projection import project_scan as j_project_scan
from rolo_tpu.prior import association as jas
from rolo_tpu.prior import ground as jgr
from rolo_tpu.prior import vehicle as jve
from rolo_tpu.sim import SimConfig as JSimConfig
from rolo_tpu.sim import dataset as jds

from rolo_tpu_torch.mapping import backend as bk
from rolo_tpu_torch.pointcloud.cloud import PaddedCloud
from rolo_tpu_torch.pointcloud.ground_seg import segment_ground
from rolo_tpu_torch.pointcloud.projection import RingImage
from rolo_tpu_torch.prior import association as pas
from rolo_tpu_torch.prior import ground as gr
from rolo_tpu_torch.prior import vehicle as ve
from rolo_tpu_torch.sim import dataset as pds

CFG = JPriorConfig(tolerance_roll=0.5, tolerance_pitch=0.5)
# Solver outputs between the packages (acceptance tolerance): both run the
# same f32 LM; the plane fits' sums round in different orders.
SOLVE_TOL = 1e-4


def _plane(normal=(0, 0, 1), d=0.0, extent=10.0, n=4096, seed=0, noise=0.0):
    """Samples of the plane n.p = d (tests/test_prior.py's ground)."""
    rng = np.random.default_rng(seed)
    a, b, c = normal
    xy = rng.uniform(-extent, extent, (n, 2))
    z = (d - a * xy[:, 0] - b * xy[:, 1]) / c
    if noise:
        z = z + rng.normal(0, noise, n)
    return np.column_stack([xy, z]).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _terrain():
    """The simulator's terrain under the bench trajectory, from the JAX
    simulator (the external ground-map input of the prior stack)."""
    return jds.ground_map_points(JSimConfig(period=20.0, roughness=1.2))


def _maps(pts, mask=None):
    mask = np.ones(len(pts), bool) if mask is None else mask
    return (jgr.GroundMap(jnp.asarray(pts), jnp.asarray(mask)),
            gr.GroundMap(T(pts), T(mask)))


QUERIES = np.array([[0.0, 0.0], [1.3, -2.2], [-7.9, 4.4], [9.7, 9.9], [20.0, 0.0]], np.float32)


def test_ground_map_points_match_reference():
    sim = dict(period=20.0, roughness=1.2)
    want = np.asarray(_terrain())
    got = pds.ground_map_points(pds.SimConfig(**sim), "cpu").numpy()
    assert got.shape == want.shape == (104 * 104, 3)
    np.testing.assert_allclose(got, want, atol=1e-5)


@pytest.mark.parametrize("ground", ["plane", "terrain", "empty"])
def test_ground_queries_match_reference(ground):
    """nearest_point_xy, average_height_at, fit_local_surface and
    contact_point for a batch of queries (1e-5 m; the reference maps one
    query at a time)."""
    if ground == "plane":
        pts = _plane(normal=(-0.2, 0.1, 1.0), d=0.5, n=8192, noise=0.01)
        pts[:80, 2] = 50.0  # outliers the fit rejects
        mask = None
    elif ground == "terrain":
        pts, mask = np.asarray(_terrain()), None
    else:
        pts, mask = np.zeros((64, 3), np.float32), np.zeros(64, bool)
    jgm, gm = _maps(pts, mask)
    q = QUERIES * (2.5 if ground == "terrain" else 1.0)
    jq = jnp.asarray(q)
    np.testing.assert_allclose(gr.nearest_point_xy(gm, T(q)).numpy(),
                               np.asarray(jax.vmap(lambda x: jgr.nearest_point_xy(jgm, x))(jq)),
                               atol=1e-6)
    h, ok = gr.average_height_at(gm, T(q), 0.6, 5)
    jh, jok = jax.vmap(lambda x: jgr.average_height_at(jgm, x, 0.6, 5))(jq)
    np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5)
    assert bool(ok) == bool(jok[0])
    for radius in (0.6, 2.0):
        pt, ok = gr.fit_local_surface(gm, T(q), radius=radius)
        jpt, jok = jax.vmap(lambda x: jgr.fit_local_surface(jgm, x, radius=radius))(jq)
        np.testing.assert_array_equal(ok.numpy(), np.asarray(jok))
        np.testing.assert_allclose(pt.numpy(), np.asarray(jpt), atol=1e-5)
    np.testing.assert_allclose(gr.contact_point(gm, T(q)).numpy(),
                               np.asarray(jax.vmap(lambda x: jgr.contact_point(jgm, x))(jq)),
                               atol=1e-5)
    assert gr.from_cloud(PaddedCloud(T(pts), gm.mask)).xyz.shape == gm.xyz.shape


@pytest.mark.parametrize("xy,size,cap", [((0.0, 0.0), 4.0, 1024), ((3.0, -1.0), 8.0, 4096),
                                         ((30.0, 0.0), 2.0, 64)])
def test_extract_patch_matches_reference(xy, size, cap):
    """The same points in the same slots: both sort the mask stably, so ties
    keep map order in both."""
    jgm, gm = _maps(_plane(n=4096, noise=0.01))
    want = jgr.extract_patch(jgm, jnp.asarray(xy), size, cap)
    got = gr.extract_patch(gm, T(np.float32(xy)), size, cap)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))


def test_live_ground_map_matches_reference_and_round_trips():
    """Three inserts into a two-slot map (the third overwrites slot 0), then
    the numpy bridge in both directions."""
    rng = np.random.default_rng(3)
    jlive = jgr.init_live_ground(2, 256)
    live = gr.init_live_ground(2, 256, "cpu")
    for k in range(3):
        pts = _plane(n=1024, extent=6.0, seed=k, noise=0.02)
        mask = rng.random(1024) < 0.9
        c, s = np.cos(0.3 * k), np.sin(0.3 * k)
        rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        trans = np.array([k, 0.5 * k, 0.1], np.float32)
        jlive = jgr.update_live_ground(jlive, JCloud(jnp.asarray(pts), jnp.asarray(mask)),
                                       jnp.asarray(rot), jnp.asarray(trans), 256)
        live = gr.update_live_ground(live, PaddedCloud(T(pts), T(mask)), T(rot), T(trans), 256)
    want = gr.live_ground_to_numpy(jlive)
    got = gr.live_ground_to_numpy(live)
    assert set(got) == set(want) == {"xyz", "mask", "cursor"}
    np.testing.assert_array_equal(got["mask"], want["mask"])
    np.testing.assert_allclose(got["xyz"], want["xyz"], atol=1e-5)
    assert int(got["cursor"]) == 3 and bool(live.ready)
    back = gr.live_ground_from_numpy(want, "cpu")
    assert back.cursor.dtype == torch.int32 and back.mask.dtype == torch.bool
    np.testing.assert_array_equal(back.as_ground_map().xyz.numpy(), want["xyz"])
    jback = jgr.LiveGroundMap(*(jnp.asarray(got[f]) for f in jgr.LiveGroundMap._fields))
    np.testing.assert_array_equal(np.asarray(jback.mask), got["mask"])


def _port_ring(img):
    return RingImage(*(T(np.asarray(getattr(img, f))) for f in RingImage._fields))


def _col0_points(img):
    xyz, col, mask = (np.asarray(img.xyz), np.asarray(img.col), np.asarray(img.mask))
    return {tuple(p) for p in xyz[mask & (col == 0)]}


def _split(cloud, col0):
    """The valid points of a segmentation: (those that are a column-0 return
    or the origin, all others), both in output order."""
    pts = np.asarray(cloud.xyz)[np.asarray(cloud.mask)]
    at0 = np.array([tuple(p) in col0 or not p.any() for p in pts], bool)
    return pts[at0], pts[~at0]


@pytest.mark.parametrize("ground_rings", [8, 16])
def test_segment_ground_matches_reference_outside_column_zero(ground_rings):
    """A simulated 16-beam scan through both packages: every ground point
    outside column 0 agrees in value and order. The simulator lists rings
    top first, so the default 8 eligible rings have no column-0 return with
    padding beside it; with all 16 eligible, the reference emits points at
    the sensor origin (its scatter writes padding over the column-0 return)
    while the port's column-0 points are the real returns."""
    jcfg = small_config()
    frame = jax_sim_frames(1)[0]
    raw = padded_raw(np.asarray(frame.points), np.asarray(frame.ring),
                     np.asarray(frame.rel_time), jcfg.static.max_raw_points)
    sens = jcfg.sensor
    img = j_project_scan(JRawScan(*(jnp.asarray(a) for a in raw)), sens.n_scan, sens.horizon_scan,
                         sens.lidar_min_range, sens.lidar_max_range, sens.downsample_rate)
    cap = sens.n_scan * sens.horizon_scan
    want = j_segment_ground(img, sens.horizon_scan, ground_rings, 10.0, cap)
    got = segment_ground(_port_ring(img), sens.horizon_scan, ground_rings, 10.0, cap)
    col0 = _col0_points(img)
    w0, w_rest = _split(want, col0)
    g0, g_rest = _split(got, col0)
    assert len(w_rest) > 100
    np.testing.assert_array_equal(g_rest, w_rest)
    assert ((~w0.any(axis=1)).sum() > 0) == (ground_rings == 16)  # the reference's origin points
    assert g0.any(axis=1).all() and all(tuple(p) in col0 for p in g0)
    assert len(g0) >= len(w0) - (~w0.any(axis=1)).sum()


def test_segment_ground_toy_image_shows_the_reference_fault():
    """4 rings x 8 columns, 5 returns per ring at columns 0-4 on flat
    ground: the reference gives 20 ground points, 4 of them at the origin;
    the port gives the 20 real returns."""
    r, h = 4, 8
    xyz = np.zeros((r, h, 3), np.float32)
    col = np.zeros((r, h), np.int32)
    mask = np.zeros((r, h), bool)
    for b in range(r):
        for c in range(5):
            az = 0.2 * c
            rng = 5.0 + 2.0 * b
            xyz[b, c] = (rng * np.cos(az), rng * np.sin(az), -1.8)
            col[b, c], mask[b, c] = c, True
    fields = dict(xyz=xyz, rng=np.linalg.norm(xyz, axis=-1), col=col, mask=mask,
                  count=np.full(r, 5, np.int32))
    jimg = JRingImage(**{k: jnp.asarray(v) for k, v in fields.items()})
    want = j_segment_ground(jimg, h, r, 10.0, r * h)
    got = segment_ground(RingImage(**{k: T(v) for k, v in fields.items()}), h, r, 10.0, r * h)
    wpts = np.asarray(want.xyz)[np.asarray(want.mask)]
    gpts = got.xyz.numpy()[got.mask.numpy()]
    assert len(wpts) == len(gpts) == 20
    assert (~wpts.any(axis=1)).sum() == 4
    np.testing.assert_array_equal(np.sort(gpts, axis=0), np.sort(xyz[mask], axis=0))


def _vehicles(cfg):
    return jve.from_config(cfg), ve.from_config(port_config(cfg), "cpu")


def test_vehicle_from_config_matches_reference():
    for cfg in (CFG, JPriorConfig(wheel_xy=((1.2, 0.7), (1.2, -0.7), (-1.0, 0.0)),
                                  vehicle_com_z=0.6, lidar_offset_trans=(0.1, 0.0, 1.5))):
        jv, v = _vehicles(cfg)
        for field in ve.VehicleModel._fields:
            np.testing.assert_array_equal(getattr(v, field).numpy(),
                                          np.asarray(getattr(jv, field)), err_msg=field)


def test_residual_jacobian_and_initial_z_match_reference():
    jgm, gm = _maps(np.asarray(_terrain()))
    jv, v = _vehicles(CFG)
    x, y, yaw = 11.0, -6.5, 0.7
    z0 = float(jve._initial_z(jgm, jv.wheel_points_body, jnp.float32(x), jnp.float32(y),
                              jnp.float32(yaw), jv.com_z, 0.3, 5))
    got_z0 = ve._initial_z(gm, v.wheel_points_body, torch.tensor(x), torch.tensor(y),
                           torch.tensor(yaw), v.com_z, 0.3, 5)
    np.testing.assert_allclose(float(got_z0), z0, atol=1e-5)
    tilt = np.asarray(jve._rot_z(jnp.float32(yaw)) @ jnp.asarray(
        [[1.0, 0, 0], [0, np.cos(0.05), -np.sin(0.05)], [0, np.sin(0.05), np.cos(0.05)]],
        jnp.float32))
    c = ve._consts(port_config(CFG), torch.float32, "cpu")
    for z in (z0, z0 + 0.8):
        jres, jjac = jve._residual_and_jacobian(jgm, jv.wheel_points_body, jnp.float32(x),
                                                jnp.float32(y), jnp.float32(yaw), jnp.float32(z),
                                                jnp.asarray(tilt), 20.0, 1.0)
        res, jac = ve._residual_and_jacobian(gm, v.wheel_points_body, torch.tensor(x),
                                             torch.tensor(y), torch.tensor(z), T(tilt),
                                             torch.tensor(20.0), torch.tensor(1.0), c.sx, c.sy)
        scale = max(1.0, float(np.abs(jjac).max()))
        np.testing.assert_allclose(res.numpy(), np.asarray(jres), atol=1e-5 * scale)
        np.testing.assert_allclose(jac.numpy(), np.asarray(jjac), atol=1e-5 * scale)


def _solve_both(pts, x, y, yaw, cfg=CFG, mask=None):
    jgm, gm = _maps(pts, mask)
    jv, v = _vehicles(cfg)
    want = jve.solve_pose(jgm, jv, x, y, yaw, cfg)
    got = ve.solve_pose(gm, v, x, y, yaw, port_config(cfg))
    return got, want


def _same_solution(got, want):
    assert bool(got.success) == bool(want.success)
    assert bool(got.converged) == bool(want.converged)
    for field in ("z", "roll", "pitch"):
        np.testing.assert_allclose(float(getattr(got, field)), float(getattr(want, field)),
                                   atol=SOLVE_TOL, err_msg=field)
    np.testing.assert_allclose(got.wheel_signed_distances.numpy(),
                               np.asarray(want.wheel_signed_distances), atol=SOLVE_TOL)


@pytest.mark.parametrize("ground,x,y,yaw", [
    ("flat", 0.0, 0.0, 0.3), ("pitch", 0.0, 0.0, 0.0), ("roll", 0.0, 0.0, 0.0),
    ("pitch", 1.0, -2.0, 0.7), ("terrain", 11.0, -6.5, 0.7), ("terrain", -15.0, 9.0, -2.4),
    ("terrain", 3.0, 13.5, 3.0)])
def test_solve_pose_matches_reference(ground, x, y, yaw):
    pts = {"flat": lambda: _plane(n=8192, noise=0.01),
           "pitch": lambda: _plane(normal=(0.2, 0.0, 1.0), n=8192),
           "roll": lambda: _plane(normal=(0.0, 0.2, 1.0), n=8192),
           "terrain": lambda: np.asarray(_terrain())}[ground]()
    got, want = _solve_both(pts, x, y, yaw)
    _same_solution(got, want)
    assert bool(got.converged)
    yaw_out = np.arctan2(float(got.rot[1, 0]), float(got.rot[0, 0]))
    assert abs(np.arctan2(np.sin(yaw_out - yaw), np.cos(yaw_out - yaw))) < 1e-3


def test_solve_pose_fails_on_empty_ground():
    got, want = _solve_both(np.zeros((64, 3), np.float32), 0.0, 0.0, 0.0,
                            mask=np.zeros(64, bool))
    _same_solution(got, want)
    assert not bool(got.success)


def test_solve_pose_singular_system_matches_reference():
    """With no spring (k = 0) and no damping (lambda = 0) the LM system is
    the zero matrix: the reference's solve returns non-finite steps, the
    port's solve_ex reports them, and both reject every step."""
    cfg = dataclasses.replace(CFG, k_spring=0.0, lm_lambda=0.0, max_iters=6)
    a = jnp.zeros((3, 3))
    assert not bool(jnp.all(jnp.isfinite(jnp.linalg.solve(a, jnp.ones(3)))))
    delta, solvable = ve._solve3(torch.zeros(3, 3), torch.ones(3))
    assert not bool(solvable) and not bool(delta.any())
    got, want = _solve_both(_plane(n=2048), 0.0, 0.0, 0.0, cfg)
    _same_solution(got, want)
    assert not bool(got.converged)
    np.testing.assert_allclose(float(got.z), float(want.z), atol=SOLVE_TOL)


def test_compute_prior_matches_reference():
    pts = np.asarray(_terrain())
    jgm, gm = _maps(pts)
    jv, v = _vehicles(CFG)
    want = jas.compute_prior(jgm, jv, jnp.float32(11.0), jnp.float32(-6.5), jnp.float32(0.7),
                             CFG, 1024)
    got = pas.compute_prior(gm, v, torch.tensor(11.0), torch.tensor(-6.5), torch.tensor(0.7),
                            port_config(CFG), 1024)
    assert bool(got.success) and bool(want.success)
    np.testing.assert_allclose(got.trans.numpy(), np.asarray(want.trans), atol=SOLVE_TOL)
    assert rot_diff_rad(got.rot.numpy(), np.asarray(want.rot)) < SOLVE_TOL
    np.testing.assert_array_equal(got.patch_mask.numpy(), np.asarray(want.patch_mask))
    np.testing.assert_array_equal(got.patch_xyz.numpy(), np.asarray(want.patch_xyz))


def test_slerp_matches_reference():
    rng = np.random.default_rng(5)
    qs = rng.normal(size=(6, 4)).astype(np.float32)
    qs /= np.linalg.norm(qs, axis=1, keepdims=True)
    pairs = [(qs[0], qs[1]), (qs[2], -qs[2]), (qs[3], qs[3]), (qs[4], -qs[5])]
    for a, b in pairs:
        for t in (0.0, 0.2, 0.7):
            np.testing.assert_allclose(pas._slerp(T(a), T(b), t).numpy(),
                                       np.asarray(jas._slerp(jnp.asarray(a), jnp.asarray(b), t)),
                                       atol=1e-6)


def _observation(x, cfg=CFG, cap=256):
    jgm, _ = _maps(_plane(n=8192, noise=0.005))
    obs = jas.compute_prior(jgm, jve.from_config(cfg), jnp.float32(x), jnp.float32(0.0),
                            jnp.float32(0.0), cfg, cap)
    return obs, pas.PriorObservation(*(T(np.asarray(f)) for f in obs))


def test_push_prior_matches_reference():
    """Three pushes into a two-slot queue (the third wraps to slot 0) and one
    disabled push: the port writes rows in place, the reference copies."""
    jq, q = jas.init_queue(2, 256), pas.init_queue(2, 256, "cpu")
    for k, (x, enable) in enumerate([(1.0, True), (2.0, False), (3.0, True), (4.0, True)]):
        jobs, obs = _observation(x)
        rot = np.asarray(_se3(np.eye(3), [0.5 * k, 0.1, 1.0]).rot)
        trans = np.array([0.5 * k, 0.1, 1.0], np.float32)
        jq = jas.push_prior(jq, jobs, jnp.asarray(k), jnp.asarray(rot), jnp.asarray(trans),
                            enable=jnp.asarray(enable), obs_time=jnp.asarray(0.1 * k))
        q = pas.push_prior(q, obs, torch.tensor(k), T(rot), T(trans), enable=torch.tensor(enable),
                           obs_time=0.1 * k)
    for field in pas.PriorQueue._fields:
        np.testing.assert_allclose(getattr(q, field).numpy(), np.asarray(getattr(jq, field)),
                                   atol=1e-6, err_msg=field)
    assert int(q.count) == 3


def _association_inputs(current_xy, cfg):
    jgm, _ = _maps(_plane(n=8192, noise=0.005))
    obs, _ = _observation(3.0, cfg, 1024)
    q = jas.push_prior(jas.init_queue(8, 1024), obs, jnp.asarray(0), jnp.eye(3),
                       jnp.asarray([0.0, 0.0, 1.0]))
    cur = jnp.asarray([current_xy[0], current_xy[1], 1.0], jnp.float32)
    return (q.rel_rot[0], q.rel_trans[0], q.linked_key[0],
            JCloud(q.patch_xyz[0], q.patch_mask[0]), q.valid[0], jnp.eye(3),
            jnp.asarray([0.0, 0.0, 1.0]), jnp.asarray(5), jnp.eye(3), cur,
            JCloud(jgm.xyz, jgm.mask))


@pytest.mark.parametrize("current_xy,accepted", [((3.0, 0.0), True), ((3.3, 0.2), True),
                                                 ((8.0, 0.0), False)])
def test_associate_prior_matches_reference(current_xy, accepted):
    cfg = JPriorConfig(near_prior_radius=2.0, fitness_score=0.05, tolerance_roll=0.5,
                       tolerance_pitch=0.5)
    args = _association_inputs(current_xy, cfg)
    want = jas.associate_prior(*args, cfg)
    conv = [PaddedCloud(T(np.asarray(a.xyz)), T(np.asarray(a.mask))) if isinstance(a, JCloud)
            else T(np.asarray(a)) for a in args]
    got = pas.associate_prior(*conv, port_config(cfg))
    assert bool(got.accepted) == bool(want.accepted) == accepted
    assert (int(got.i), int(got.j)) == (int(want.i), int(want.j)) == (0, 5)
    assert rot_diff_rad(got.rel_rot.numpy(), np.asarray(want.rel_rot)) < 1e-4
    np.testing.assert_allclose(got.rel_trans.numpy(), np.asarray(want.rel_trans), atol=1e-5)
    np.testing.assert_allclose(got.noise_var.numpy(), np.asarray(want.noise_var), rtol=1e-3)


def _prior_cfg():
    return dataclasses.replace(SMALL, prior=JPriorConfig(
        near_prior_radius=2.0, fitness_score=0.05, tolerance_roll=0.5, tolerance_pitch=0.5))


@pytest.mark.parametrize("prior_xs,matched", [((8.0, 3.0), True), ((8.0, 9.0), False)])
def test_prior_step_matches_reference(prior_xs, matched):
    """tests/test_backend.py's scenario: keyframes at x = 0 and 3, priors
    linked to keyframe 0; the entry near keyframe 1 becomes factor 0 -> 1."""
    cfg = _prior_cfg()
    jstate, jground = TestPriorStep()._state_with_priors(cfg, list(prior_xs))
    want, wmatched = jbk.prior_step(jstate, jground, cfg)
    state = bk.backend_state_from_numpy(bk.backend_state_to_numpy(jstate), "cpu")
    got, gmatched = bk.prior_step(state, PaddedCloud(T(np.asarray(jground.xyz)),
                                                     T(np.asarray(jground.mask))),
                                  port_config(cfg))
    assert bool(gmatched) == bool(wmatched) == matched
    g, w = bk.backend_state_to_numpy(got), bk.backend_state_to_numpy(want)
    for key in ("graph.priors.count", "graph.priors.i", "graph.priors.j", "graph.priors.valid",
                "pending_solve", "dropped_counts"):
        np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    np.testing.assert_allclose(g["graph.priors.rel_trans"], w["graph.priors.rel_trans"], atol=1e-5)
    np.testing.assert_allclose(g["graph.priors.noise_var"], w["graph.priors.noise_var"], rtol=1e-3)


@functools.lru_cache(maxsize=None)
def _record_setup(n_keyframes, synced_interval):
    cfg = dataclasses.replace(SMALL, prior=JPriorConfig(synced_interval=synced_interval,
                                                        tolerance_roll=0.5, tolerance_pitch=0.5))
    pts = _plane(n=8192, extent=12.0, noise=0.005)
    st = jbk.init_backend(cfg)
    dummy = JCloud.from_points(pts[:64], cfg.static.max_corner_points)
    dummy_s = JCloud.from_points(pts[:64], cfg.static.max_surf_points)
    db = st.db
    for i in range(n_keyframes):
        db = j_add_keyframe(db, _se3(np.eye(3), [float(i), 0.0, 1.0]), jnp.asarray(float(i)),
                            dummy, dummy_s)
    obs = jas.compute_prior(jgr.GroundMap(jnp.asarray(pts), jnp.ones(len(pts), bool)),
                            jve.from_config(cfg.prior), jnp.float32(2.0), jnp.float32(0.0),
                            jnp.float32(0.0), cfg.prior, st.prior_queue.patch_xyz.shape[1])
    return st._replace(db=db), obs, cfg


@pytest.mark.parametrize("n_kf,synced,times,count", [
    (5, 0.0, (4.0,), 0), (12, 0.0, (11.5,), 0), (12, 0.0, (11.0,), 1),
    (12, 5.0, (11.0, 11.004), 1), (2, 0.0, (None,), 1)])
def test_record_prior_observation_matches_reference(n_kf, synced, times, count):
    """The reference's gates: more than 10 keyframes, 10 ms sync to the
    latest keyframe, synced_interval between accepted priors; without a
    time only the keyframe-count gate applies."""
    jstate, jobs, cfg = _record_setup(n_kf, synced)
    state = bk.backend_state_from_numpy(bk.backend_state_to_numpy(jstate), "cpu")
    obs = pas.PriorObservation(*(T(np.asarray(f)) for f in jobs))
    for t in times:
        if t is None:
            jstate = jbk.record_prior_observation(jstate, jobs)
            state = bk.record_prior_observation(state, obs)
        else:
            jstate = jbk.record_prior_observation(jstate, jobs, obs_time=jnp.asarray(t), cfg=cfg)
            state = bk.record_prior_observation(state, obs, obs_time=t, cfg=port_config(cfg))
    g, w = bk.backend_state_to_numpy(state), bk.backend_state_to_numpy(jstate)
    assert int(g["prior_queue.count"]) == int(w["prior_queue.count"]) == count
    for key in ("prior_queue.linked_key", "prior_queue.valid", "prior_queue.patch_mask",
                "prior_queue.last_time", "dropped_counts"):
        np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    np.testing.assert_allclose(g["prior_queue.rel_trans"], w["prior_queue.rel_trans"], atol=1e-5)
    np.testing.assert_allclose(g["prior_queue.patch_xyz"], w["prior_queue.patch_xyz"], atol=1e-6)


def test_record_prior_observation_counts_queue_wraps():
    """dropped_counts[3] counts each accepted push into a full queue."""
    jstate, jobs, cfg = _record_setup(12, 0.0)
    small_q = jas.init_queue(2, jstate.prior_queue.patch_xyz.shape[1])
    jstate = jstate._replace(prior_queue=small_q)
    state = bk.backend_state_from_numpy(bk.backend_state_to_numpy(jstate), "cpu")
    obs = pas.PriorObservation(*(T(np.asarray(f)) for f in jobs))
    for _ in range(4):
        jstate = jbk.record_prior_observation(jstate, jobs, obs_time=jnp.asarray(11.0), cfg=cfg)
        state = bk.record_prior_observation(state, obs, obs_time=11.0, cfg=port_config(cfg))
    np.testing.assert_array_equal(state.dropped_counts.numpy(), np.asarray(jstate.dropped_counts))
    assert state.dropped_counts.tolist() == [0, 0, 0, 2]
