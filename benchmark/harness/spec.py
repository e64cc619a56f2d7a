"""What a run is told: the cell from `BENCHMARK.json`, and the files that the
cell's names lead to under the benchmark's folder.

- `configs/<config>.json`: the deployment's YAML files (frozen copies),
  the simulated sensor, and the whole resolved `RoloConfig` pinned field by
  field. Set-up loads the YAML through the program's own
  `config.load_config` and compares the result with the pin.
- `traffic/<traffic>.json`: the parameters one of the general drivers of
  `drivers.py` reads (its world, lengths, sampling).
- `limits/<cell>.json`: the limit of every number the check compares.
- `metrics/<metric>.py`: the reader of one per-layer metric.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
from typing import Dict, List, NamedTuple, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)


class Cell(NamedTuple):
    name: str
    config: Dict
    traffic: Dict
    limits: Dict
    end_to_end: List[Dict]
    per_layer: List[Dict]


def _load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark_file() -> Dict:
    return _load_json(os.path.join(ROOT, "BENCHMARK.json"))


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, bench: Optional[Dict] = None) -> Cell:
    """The cell `name` with its configuration, traffic, limits and metrics."""
    bench = benchmark_file() if bench is None else bench
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = _load_json(os.path.join(ROOT, configs[w["config"]]["file"]))
    traffic = _load_json(os.path.join(BENCH_DIR, "traffic", f"{w['traffic']}.json"))
    limits = _load_json(os.path.join(BENCH_DIR, "limits", f"{name}.json"))
    return Cell(name, config, traffic, limits,
                [m for m in bench["end_to_end"] if _applies(m, name)],
                [m for m in bench["per_layer"] if _applies(m, name)])


def metric_reader(name: str):
    """The `read(trace)` function of `metrics/<name>.py`."""
    path = os.path.join(BENCH_DIR, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"bench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def resolve_config(config: Dict):
    """The RoloConfig the deployment's YAML files (and any dotted
    overrides) give through the program's own loader."""
    from rolo_tpu_torch.config import load_config

    paths = [os.path.join(BENCH_DIR, p) for p in config["yaml"]]
    return load_config(paths, config.get("overrides") or None)


def as_pin(cfg) -> Dict:
    """A RoloConfig as the JSON the configuration file pins."""
    return json.loads(json.dumps(dataclasses.asdict(cfg)))


def _flatten(d: Dict, prefix: str = "") -> Dict:
    out = {}
    for k, v in d.items():
        key = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, key + "."))
        else:
            out[key] = v
    return out


def pin_mismatches(cfg, pinned: Dict) -> List[str]:
    """Dotted fields where the resolved config and the pin differ, or that
    one of them lacks."""
    got, want = _flatten(as_pin(cfg)), _flatten(pinned)
    return sorted(k for k in set(got) | set(want) if got.get(k, None) != want.get(k, None)
                  or (k in got) != (k in want))
