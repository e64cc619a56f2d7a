"""Deskew on and off at full width on the CPU: the front-end's position error
per scan against ground truth over the first scans of the simulated lap that
chip_smoke.py phases 5-6 run (32 x 1024, `bench_sim_config`, `RoloConfig()`
with loop closure and priors off). The same frames, made by the port's
simulator, feed every run.

    JAX_PLATFORMS=cpu python tests/torch_deskew_ab.py [n_scans] [run,run,...]

Runs (all by default): `port_on`, `port_off`, `jax_on`, `jax_off` (each
package's SlamSystem with its ESKF-fed deskew, and without deskew), and the
port's deskew fed the simulator's exact sensor motion over each sweep in
place of the filter's estimate: `exact`, `exact_negated`, `exact_rotation`
(its rotation alone), `exact_translation` (its translation alone).

Not a test: the JAX package's programs at full width take tens of minutes
to compile and run on the CPU.
"""

import dataclasses
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from rolo_tpu_torch import bench  # noqa: E402
from rolo_tpu_torch.config import RoloConfig  # noqa: E402
from rolo_tpu_torch.geometry import so3  # noqa: E402
from rolo_tpu_torch.runtime.slam import SlamSystem  # noqa: E402
from rolo_tpu_torch.sim.dataset import generate_sequence, make_scene  # noqa: E402
from rolo_tpu_torch.sim.scene import loop_trajectory_pose  # noqa: E402

RUNS = ("port_on", "port_off", "jax_on", "jax_off", "exact", "exact_negated", "exact_rotation",
        "exact_translation")


def _config(base, deskew: bool):
    return base.replace(sensor=dataclasses.replace(base.sensor, deskew_enabled=deskew),
                        loop=dataclasses.replace(base.loop, enable=False),
                        prior=dataclasses.replace(base.prior, enable=False))


def _exact_increment(sim_cfg, scene, run: str, clock: dict):
    """A `_deskew_increment` from the simulator's trajectory: the sensor's
    motion over the sweep that starts at `clock["t"]`, in its start frame."""
    def pose(t):
        return loop_trajectory_pose(scene, torch.tensor(t, dtype=torch.float32),
                                    radius_x=sim_cfg.radius_x, radius_y=sim_cfg.radius_y,
                                    period=sim_cfg.period, sensor_height=sim_cfg.sensor_height)

    def increment(interval):
        (r0, p0), (r1, p1) = pose(clock["t"]), pose(clock["t"] + interval)
        rpy, vel = -torch.stack(so3.matrix_to_rpy(r0.T @ r1)), r0.T @ (p1 - p0)
        sign = -1.0 if run == "exact_negated" else 1.0
        return (rpy * sign * (run != "exact_translation"),
                vel * sign * (run != "exact_rotation"))

    return increment


def _make(run: str, sim_cfg, scene, clock: dict):
    if run.startswith("jax"):
        from rolo_tpu.config import RoloConfig as JRoloConfig
        from rolo_tpu.runtime.slam import SlamSystem as JSlamSystem

        return JSlamSystem(_config(JRoloConfig(), run == "jax_on"))
    slam = SlamSystem(_config(RoloConfig(), run != "port_off"), "cpu")
    if run.startswith("exact"):
        slam._deskew_increment = _exact_increment(sim_cfg, scene, run, clock)
    return slam


def main(n_scans: int, runs) -> None:
    sim_cfg = bench.bench_sim_config(n_scans)
    scene = make_scene(sim_cfg, "cpu")
    frames = list(generate_sequence(sim_cfg, "cpu", scene))
    g_rot = torch.stack([f.gt_rot for f in frames]).double()
    g_trans = torch.stack([f.gt_trans for f in frames]).double()
    gt0 = (g_rot[0].T @ (g_trans - g_trans[0]).T).T.numpy()  # in frame 0's coordinates
    for run in runs:
        clock = {}
        slam, t0 = _make(run, sim_cfg, scene, clock), time.perf_counter()
        for f in frames:
            clock["t"] = f.stamp
            slam.process_scan(f.points.numpy(), f.stamp, ring=f.ring.numpy(),
                              rel_time=f.rel_time.numpy())
        err = np.linalg.norm(slam.front_positions_np() - gt0, axis=1)
        print(f"{run}: front-end ATE {np.sqrt((err ** 2).mean()):.4f} m, "
              f"error per scan {err.round(4).tolist()} "
              f"({time.perf_counter() - t0:.0f} s)", flush=True)


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 11,
         sys.argv[2].split(",") if len(sys.argv) > 2 else RUNS)
