"""The contact solves of the prior cycle on chip_smoke.py phase 14's live
ground maps, in both packages (a script, not a test):

    JAX_PLATFORMS=cpu python tests/torch_m2ud_contact.py [scans]

Runs the port's SlamSystem on the CPU over the first `scans` (default 80)
scans of phase 14's M2UD sequence (a VLP-16 0.45 m up, configs/m2ud/).
At every prior tick it solves the contact pose twice on the same live
ground map and query: with the port's `prior/vehicle.solve_pose` and with
the reference's (`rolo_tpu`, on JAX). It prints each tick's verdicts and
roll, the ground points within ground_avg_radius of each wheel, the
success counts, and the backward error |a x - b| / (|a| |x| + |b|) of
every LM step the port's solver took: its own step (`_solve3`) and the
reference's `jnp.linalg.solve` on the same system, over the steps each
found solvable (a singular system gives non-finite steps in both, which
the LM rejects). ~12 min on 4 CPU threads."""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from torch_parity import port_config  # noqa: E402

from rolo_tpu.config import load_config as jload_config  # noqa: E402
from rolo_tpu.prior import ground as jgr  # noqa: E402
from rolo_tpu.prior import vehicle as jve  # noqa: E402

from rolo_tpu_torch.prior import association  # noqa: E402
from rolo_tpu_torch.prior import vehicle as ve  # noqa: E402
from rolo_tpu_torch.runtime.slam import SlamSystem  # noqa: E402


def _backward_error(a, b, x) -> float:
    a, b, x = (np.asarray(t, np.float64) for t in (a, b, x))
    return float(np.linalg.norm(a @ x - b)
                 / (np.linalg.norm(a) * np.linalg.norm(x) + np.linalg.norm(b)))


def main(n_scans: int) -> None:
    jcfg = jload_config(list(chip_smoke.M2UD_CONFIGS))
    cfg = port_config(jcfg)
    pc = jcfg.prior
    jvehicle = jve.from_config(pc)
    real_solve, real_step = association.solve_pose, ve._solve3
    rows, steps = [], []

    def step(a, b):
        x, ok = real_step(a, b)
        want = np.asarray(jnp.linalg.solve(jnp.asarray(a.numpy()), jnp.asarray(b.numpy())))
        solved = np.isfinite(want).all()
        steps.append((_backward_error(a, b, x) if bool(ok) else np.nan,
                      _backward_error(a, b, want) if solved else np.nan))
        return x, ok

    def contact(gm, vehicle, x, y, yaw, prior_cfg):
        ve._solve3 = step
        try:
            got = real_solve(gm, vehicle, x, y, yaw, prior_cfg)
        finally:
            ve._solve3 = real_step
        pts, mask = gm.xyz.numpy(), gm.mask.numpy()
        want = jve.solve_pose(jgr.GroundMap(jnp.asarray(pts), jnp.asarray(mask)), jvehicle,
                              float(x), float(y), float(yaw), pc)
        c, s = np.cos(float(yaw)), np.sin(float(yaw))
        near = [int((np.hypot(pts[mask, 0] - (float(x) + c * wx - s * wy),
                              pts[mask, 1] - (float(y) + s * wx + c * wy))
                     < pc.ground_avg_radius).sum()) for wx, wy in pc.wheel_xy]
        rows.append((bool(got.success), bool(want.success), float(got.roll), float(want.roll),
                     near))
        return got

    association.solve_pose = contact
    try:
        slam = SlamSystem(cfg, "cpu")
        sim = chip_smoke.m2ud_sim_config(cfg, n_scans)
        for stamp, xyz, ring, rel, _, _ in chip_smoke.m2ud_scans(sim, "cpu"):
            slam.process_scan(xyz, stamp, ring=ring.astype(np.int32), rel_time=rel)
    finally:
        association.solve_pose = real_solve
    for i, (ok, jok, roll, jroll, near) in enumerate(rows):
        print(f"tick {i}: success port {ok} reference {jok}, roll port {roll:.3f} reference "
              f"{jroll:.3f}, ground points near the wheels {near}")
    err = np.array(steps)
    print(f"contact solves accepted: port {sum(r[0] for r in rows)}, reference "
          f"{sum(r[1] for r in rows)}, of {len(rows)}; the same verdict "
          f"{sum(r[0] == r[1] for r in rows)}; wheels with >= {pc.ground_min_neighbors} ground "
          f"points within {pc.ground_avg_radius} m: "
          f"{sum(sum(n >= pc.ground_min_neighbors for n in r[4]) for r in rows)} of "
          f"{4 * len(rows)}")
    unsolved = np.isnan(err).sum(0)
    print(f"LM steps {len(err)}, found singular (non-finite) by the port's step {unsolved[0]}, by "
          f"the reference's LU {unsolved[1]}; backward error of the others: the port's step "
          f"median {np.nanmedian(err[:, 0]):.2e} max {np.nanmax(err[:, 0]):.2e}, the reference's "
          f"median {np.nanmedian(err[:, 1]):.2e} max {np.nanmax(err[:, 1]):.2e}")


if __name__ == "__main__":
    torch.set_num_threads(4)
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 80)
