"""A cell at a size the CPU runs in seconds, for the benchmark's own tests:
a 16-beam sensor at 512 columns, the shipped VLP-32 files with every
capacity cut, and short traffic. Its limits are the vlp32 cells' limits."""

from __future__ import annotations

import copy
import json
import os

from benchmark.harness import spec

OVERRIDES = {
    "sensor.n_scan": 16, "sensor.horizon_scan": 512, "sensor.lidar_min_range": 1.0,
    "sensor.lidar_max_range": 40.0, "mapping.scan2map_max_iterations": 6,
    "static.max_raw_points": 4096, "static.max_corner_points": 256,
    "static.max_surf_points": 768, "static.max_feature_points": 1024, "static.max_voxels": 2048,
    "static.max_keyframes": 64, "static.max_submap_points": 2048, "static.max_loop_factors": 16,
    "static.max_prior_factors": 16, "static.knn_query_chunk": 256,
}
SENSOR = {"beams": 16, "elev_top_deg": 15.0, "elev_bottom_deg": -15.0, "cols": 512,
          "min_range": 1.0, "max_range": 40.0, "ring_order": "bottom_first"}


def _load(rel: str) -> dict:
    with open(os.path.join(spec.BENCH_DIR, rel)) as f:
        return json.load(f)


def tiny_cell(traffic: str) -> spec.Cell:
    config = _load("configs/vlp32.json")
    config = dict(config, name="tiny", overrides=dict(OVERRIDES), sensor=dict(SENSOR))
    config["pinned"] = spec.as_pin(spec.resolve_config(config))
    t = copy.deepcopy(_load(f"traffic/{traffic}.json"))
    if t["driver"] == "stream":
        t.update(warmup_scans=4, check_scans=1, check_from=1, kernel_calls_checked=4,
                 profile_from=1, profile_scans=2)
    else:
        t.update(logs=2, scans_per_log=8, warmup_indices=2, check_from=2, check_indices=2,
                 kernel_calls_checked=4, profile_from=1, profile_indices=2)
    cell_name = "vlp32.stream" if t["driver"] == "stream" else "vlp32.batch16"
    bench = spec.benchmark_file()
    real = spec.load_cell(cell_name, bench)
    return spec.Cell(f"tiny.{traffic}", config, t, dict(real.limits), real.end_to_end,
                     real.per_layer)
