"""Per-stage timing and device tracing, the port's counterpart of
`rolo_tpu/runtime/profiling.py`.

`StageTimers` records wall-clock samples per pipeline stage, as the
reference's printf timers around its solvers do (lidarOdometry.cpp:449-498);
`device_trace` records a torch.profiler trace of the card and writes it as a
Chrome trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import numpy as np
import torch


def _synchronize(value) -> None:
    """Wait for the card when `value` (a tensor, or a tuple of them) lives
    there; nothing to wait for on the CPU."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            torch.cuda.synchronize(value.device)
    elif isinstance(value, (tuple, list)):
        for item in value:
            _synchronize(item)


class StageTimers:
    """Accumulates wall-clock samples per pipeline stage.

    A stage without `sync` times the host's work: device work it enqueued
    and did not wait for lands in a later stage. `SequenceResult.wall_s`
    stays an end-to-end number."""

    def __init__(self) -> None:
        self._samples: Dict[str, list] = defaultdict(list)

    @contextlib.contextmanager
    def stage(self, name: str, sync=None) -> Iterator[None]:
        """Time a stage; with `sync` (a tensor, or a callable returning one)
        the time includes the card's work up to it."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                _synchronize(sync() if callable(sync) else sync)
            self._samples[name].append(time.perf_counter() - t0)

    def record(self, name: str, seconds: float) -> None:
        self._samples[name].append(seconds)

    def reset(self) -> None:
        """Drop the samples (to leave warm-up scans out of a measurement)."""
        self._samples.clear()

    def summary(self) -> Dict[str, Dict[str, float]]:
        """{stage: {count, mean_ms, p50_ms, p95_ms, max_ms, total_s}}."""
        out = {}
        for name, xs in self._samples.items():
            a = np.asarray(xs)
            out[name] = {
                "count": int(a.size),
                "mean_ms": float(a.mean() * 1e3),
                "p50_ms": float(np.percentile(a, 50) * 1e3),
                "p95_ms": float(np.percentile(a, 95) * 1e3),
                "max_ms": float(a.max() * 1e3),
                "total_s": float(a.sum()),
            }
        return out

    def report(self) -> str:
        rows = sorted(self.summary().items(), key=lambda kv: -kv[1]["total_s"])
        lines = [f"{'stage':24s} {'count':>7s} {'mean':>9s} {'p95':>9s} {'total':>9s}"]
        for name, s in rows:
            lines.append(f"{name:24s} {s['count']:7d} {s['mean_ms']:7.2f}ms "
                         f"{s['p95_ms']:7.2f}ms {s['total_s']:8.2f}s")
        return "\n".join(lines)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    """torch.profiler trace of the host and the card, written to
    `log_dir/trace.json` (Chrome trace format: chrome://tracing or
    Perfetto); a no-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
