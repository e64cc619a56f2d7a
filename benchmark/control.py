"""Read the check's numbers of a cell with something put in the program's
place, on the card, at the cell's own size: the control (both kernels
computed by the plain reference in TF32) and the planted faults of
`harness/variants.py`. The benchmark's own runs never do this; the limits
in `limits/<cell>.json` are set from these readings and the sound runs'.

    python benchmark/control.py --workload vlp32.stream --seeds 11,12,13 \
        --seconds 20 --variants control,fault_state_unchanged

Runs every (variant, seed) in one process, one after the other, and
prints one JSON line for each: the variant, the seed, `correct` and the
numbers compared. `--variants sound` reads the program as it is.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--variants", required=True, help="comma-separated; 'sound' for none")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("control.py needs a CUDA card", file=sys.stderr)
        return 2
    from benchmark.harness import drivers, platform, spec

    platform.full_f32()
    cell = spec.load_cell(args.workload)
    print(f"card: {platform.nvidia_smi_name_power()}", file=sys.stderr)
    for variant in args.variants.split(","):
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            try:
                run = drivers.run_cell(cell, seed, args.seconds, False, "cuda", t0,
                                       None if variant == "sound" else variant)
            except Exception as exc:  # a variant that raises has failed; go on
                print(json.dumps({"workload": cell.name, "variant": variant, "seed": seed,
                                  "error": repr(exc)[:500]}), flush=True)
                gc.collect()
                torch.cuda.empty_cache()
                continue
            out = run["outcome"]
            print(json.dumps({"workload": cell.name, "variant": variant, "seed": seed,
                              "correct": run["correct"], "attempted": out.attempted,
                              "numbers": run["numbers"], "end_to_end": out.end_to_end,
                              "wall_s": time.perf_counter() - t0}), flush=True)
            del run, out
            gc.collect()
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
