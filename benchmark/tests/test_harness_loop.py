"""The plain reference of the radius-search loop closure
(`reference/loop.py`) and `loop_check.py`'s comparison, on the CPU: the
radius search's gates, ICP recovering a known motion in float64 and not in
bfloat16, the factor, and a candidate compared with itself, with a 1 cm
fault and with a rejection."""

from __future__ import annotations

import math

import pytest
import torch

from benchmark import loop_check
from benchmark.reference import loop as ref_loop


def _rot_z(yaw: float) -> torch.Tensor:
    c, s = math.cos(yaw), math.sin(yaw)
    return torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=torch.float64)


def _scene(n=1500, seed=0):
    """Points on a ground plane, two walls and a few poles, within 20 m."""
    g = torch.Generator().manual_seed(seed)
    u = torch.rand(n, 3, generator=g, dtype=torch.float64)
    k = n // 3
    ground = torch.stack([40 * u[:k, 0] - 20, 40 * u[:k, 1] - 20, -0.45 + 0 * u[:k, 2]], -1)
    wall_a = torch.stack([30 * u[k:2 * k, 0] - 15, 6.0 + 0 * u[k:2 * k, 1], 3 * u[k:2 * k, 2]], -1)
    wall_b = torch.stack([-9.0 + 0 * u[2 * k:, 0], 24 * u[2 * k:, 1] - 12, 3 * u[2 * k:, 2]], -1)
    poles = torch.tensor([[3.0, -4.0], [-5.0, 2.0], [8.0, 3.0]], dtype=torch.float64)
    z = torch.linspace(-0.4, 2.5, 30, dtype=torch.float64)
    pole_pts = torch.cat([torch.stack([p[0].expand(30), p[1].expand(30), z], -1) for p in poles])
    return torch.cat([ground, wall_a, wall_b, pole_pts])


@pytest.mark.parametrize("case,want", [("found", 2), ("too_recent", None), ("matched", None),
                                       ("too_far", None)])
def test_detect_radius(case, want):
    trans = torch.tensor([[0.0, 0, 0], [10.0, 0, 0], [1.0, 0, 0], [2.0, 0, 0], [1.2, 0, 0]])
    time = torch.tensor([0.0, 10.0, 20.0, 40.0, 100.0])
    matched = torch.zeros(5, dtype=torch.bool)
    radius = 30.0
    if case == "too_recent":
        time = time.clone()
        time[4] = 21.0
        time[0] = 19.0  # 2 s apart only
    if case == "matched":
        matched[4] = True
    if case == "too_far":
        radius = 0.05
    # keyframe 2 (0.2 m away) is nearer than 3 (0.8 m) and 0 (1.2 m)
    assert ref_loop.detect_radius(trans, time, 5, matched, radius, 30.0) == want


def test_icp_recovers_a_known_motion_in_float64_not_in_bfloat16():
    tgt = _scene()
    rot, trans = _rot_z(0.05), torch.tensor([0.3, -0.2, 0.02], dtype=torch.float64)
    src = (tgt - trans) @ rot  # tgt = rot @ src + trans
    mask = torch.ones(src.shape[0], dtype=torch.bool)
    res = ref_loop.icp(src, mask, tgt, mask, torch.eye(3, dtype=torch.float64),
                       torch.zeros(3, dtype=torch.float64), 60.0)
    assert res.pairs == src.shape[0] and res.fitness < 1e-12 and res.iterations < 100
    assert float((res.rot - rot).abs().max()) < 1e-8
    assert float((res.trans - trans).abs().max()) < 1e-8
    low = ref_loop.icp(src, mask, tgt, mask, torch.eye(3, dtype=torch.float64),
                       torch.zeros(3, dtype=torch.float64), 60.0, dtype=torch.bfloat16)
    assert float((low.trans.double() - trans).abs().max()) > 1e-3


def _call(seed=1):
    """A verify_loop call as loop_check's tap keeps it: the current
    keyframe stored 0.3 m and 0.05 rad off the candidate's true relative
    pose, both submaps in the world frame."""
    world = _scene(seed=seed)
    cur_rot, cur_trans = _rot_z(0.05), torch.tensor([0.3, -0.2, 0.0], dtype=torch.float64)
    prev_rot, prev_trans = torch.eye(3, dtype=torch.float64), torch.zeros(3, dtype=torch.float64)
    # what the drifted current pose puts in the world: the true world moved
    src = (world @ cur_rot.T + cur_trans).float()
    mask = torch.ones(world.shape[0], dtype=torch.bool)
    store = torch.tensor([[0.0, 0, 0], [5.0, 0, 0], [0.3, -0.2, 0.0]])
    want = ref_loop.verify(cur_rot, cur_trans, prev_rot, prev_trans, src, mask, world.float(),
                           mask, 0.0, 60.0, 0.3)
    return {"cur": 2, "prev": 0, "cur_time": 40.0,
            "rows": [cur_rot.float(), cur_trans.float(), prev_rot.float(), prev_trans.float()],
            "store": (store, torch.tensor([0.0, 5.0, 40.0]), 3),
            "submaps": [src, mask, world.float(), mask], "yaw": 0.0, "max_corr_dist": 60.0,
            "fitness_threshold": 0.3,
            "factor": (want.rel_rot.float(), want.rel_trans.float(), want.variance,
                       want.accepted), "iterations": want.iterations}


def test_the_factor_undoes_the_stored_drift():
    """The ICP moves the drifted submap back, so the factor is the true
    relative pose of the two keyframes, the identity here."""
    call = _call()
    rel_rot, rel_trans, _, accepted = call["factor"]
    assert accepted
    assert float((rel_rot - torch.eye(3)).abs().max()) < 1e-5
    assert float(rel_trans.abs().max()) < 1e-5


@pytest.mark.parametrize("fault", [None, "nudged", "rejected"])
def test_loop_check_compares_a_candidate(fault):
    call = _call()
    if fault == "nudged":
        rot, trans, var, acc = call["factor"]
        call["factor"] = (rot, trans + torch.tensor([0.01, 0.0, 0.0]), var, acc)
    if fault == "rejected":
        rot, trans, var, _ = call["factor"]
        call["factor"] = (rot, trans, var, False)
    row = loop_check.compare(call, 30.0, 30.0)
    assert row["same_candidate"] and row["reference_accepted"]
    assert row["bf16_pose_gap_m"] > loop_check.TOLERANCES["loop_pose_gap_m"]
    assert row["nudged_pose_gap_m"] > loop_check.TOLERANCES["loop_pose_gap_m"]
    assert loop_check.judge([row]) == (fault is None)
    if fault is None:
        assert row["loop_pose_gap_m"] < 1e-5 and row["loop_fitness_rel_gap"] < 1e-6
    assert not loop_check.judge([])
