"""chip_smoke.py phase 14's sequence through one package's SlamSystem on the
CPU (a script, not a test):

    JAX_PLATFORMS=cpu python tests/torch_m2ud_both.py {jax|port} [scans]

configs/m2ud/'s pair with tests/test_torch_m2ud.py's cut capacities (the
keyframe store raised to 128, which holds a 34 s run), over the first
`scans` (default 340) scans of phase 14's VLP-16 sequence, the same numpy
frames for either package. Every 20 scans it prints the keyframes, loop and
prior factors, the prior observations queued and the live ground map's
points; then the final counts. Phase 14's full capacities take XLA:CPU
minutes a scan; at these the JAX package takes ~4 s a scan, the port ~2 s."""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402
from test_torch_m2ud import SCALED  # noqa: E402

from rolo_tpu_torch.config import load_config  # noqa: E402

CAPACITIES = {**SCALED, "static.max_keyframes": 128}


def main(package: str, n_scans: int) -> None:
    cfg = load_config(list(chip_smoke.M2UD_CONFIGS), CAPACITIES)
    frames = chip_smoke.m2ud_scans(chip_smoke.m2ud_sim_config(cfg, n_scans), "cpu")
    if package == "jax":
        import jax

        jax.config.update("jax_platforms", "cpu")
        from rolo_tpu.config import load_config as jload_config
        from rolo_tpu.runtime.slam import SlamSystem as JSlamSystem

        slam = JSlamSystem(jload_config(list(chip_smoke.M2UD_CONFIGS), CAPACITIES))
    else:
        from rolo_tpu_torch.runtime.slam import SlamSystem

        slam = SlamSystem(cfg, "cpu")

    def counts() -> str:
        st = slam.backend_state
        return (f"keyframes {int(st.db.count)}, loop factors {int(st.graph.loops.count)}, prior "
                f"factors {int(st.graph.priors.count)}, observations queued "
                f"{int(st.prior_queue.count)}, live ground points "
                f"{int(np.asarray(slam.live_ground.mask).sum())}")

    t0 = time.perf_counter()
    for i, (stamp, xyz, ring, rel, _, _) in enumerate(frames, 1):
        slam.process_scan(xyz, stamp, ring=ring.astype(np.int32), rel_time=rel)
        if i % 20 == 0:
            print(f"{package} scan {i} ({time.perf_counter() - t0:.0f} s): {counts()}", flush=True)
    slam.finalize()
    loops = slam.backend_state.graph.loops
    print(f"{package} final: {counts()}; loops (i, j) "
          f"{[(int(loops.i[k]), int(loops.j[k])) for k in range(int(loops.count))]}")


if __name__ == "__main__":
    import torch

    torch.set_num_threads(3)
    main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else chip_smoke.N_M2UD)
