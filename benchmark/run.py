"""Run one cell of the benchmark of rolo_tpu_torch once, on the card.

    python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell (BENCHMARK.json's `workloads`) names
a configuration (benchmark/configs/<config>.json) and a traffic mix
(benchmark/traffic/<traffic>.json); the run makes its scans from the seed,
warms the system up, measures for `--seconds`, then checks what the timed
path produced against the plain reference and the simulator's ground
truth. The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the end-to-end metrics with `--trace 0`,
the per-layer metrics with `--trace 1`), `device`, with `--trace 1` a
`breakdown`, and last `checks`: each compared number beside its limit.
Exits non-zero, printing no result, without a CUDA card, or if JAX or the
JAX package was loaded.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# caches inside the checkout, at fixed paths (only a checkout's first run builds)
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["USE_FLAX"] = "0"
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def finite(value):
    """The result with every number that is not finite written as null
    (JSON has no infinity)."""
    if isinstance(value, dict):
        return {k: finite(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [finite(v) for v in value]
    if isinstance(value, float) and not math.isfinite(value):
        return None
    return value


def result_line(cell, run: dict, trace: bool, kind: str, count: int) -> dict:
    """The result's JSON object from `drivers.run_cell`'s output."""
    from benchmark.harness import spec

    out = run["outcome"]
    if trace:
        metrics = {}
        for m in cell.per_layer:
            value = spec.metric_reader(m["name"])(out.trace)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        values = dict(out.end_to_end, setup_s=out.setup_s)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    device = {"platform": "gpu", "kind": kind, "count": count,
              "memory_peak_bytes": int(out.memory_peak_bytes)}
    line = {"correct": bool(run["correct"]), "attempted": int(out.attempted),
            "failed": int(out.failed), "metrics": metrics, "device": device}
    if trace and out.trace is not None:
        device["busy_s"] = out.trace["busy_s"]
        device["window_s"] = out.trace["window_s"]
        line["breakdown"] = {"device_ops": out.trace["device_ops"],
                             "idle_gaps": out.trace["idle_gaps"]}
    line["checks"] = {k: {"value": v, "limit": cell.limits.get(k)}
                      for k, v in run["numbers"].items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.harness import guard, spec

    cell = spec.load_cell(args.workload)
    chips = next(w["chips"] for w in spec.benchmark_file()["workloads"]
                 if w["name"] == args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from benchmark.harness import drivers, platform

    platform.full_f32()
    run = drivers.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS)
    line = result_line(cell, run, bool(args.trace), torch.cuda.get_device_name(0), chips)
    found = guard.loaded_forbidden()
    if found:
        print(f"run.py: JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    print(f"card: {platform.nvidia_smi_name_power()}", file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(finite(line), allow_nan=False))
    return 0


if __name__ == "__main__":
    sys.exit(main())
