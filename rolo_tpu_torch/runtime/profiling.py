"""Per-stage timing and device tracing, the port's counterpart of
`rolo_tpu/runtime/profiling.py`.

`StageTimers` records wall-clock samples per pipeline stage, as the
reference's printf timers around its solvers do (lidarOdometry.cpp:449-498);
`device_trace` records a torch.profiler trace of the card and writes it as a
Chrome trace.

With `StageTimers.tracing` on, each stage also opens a
`torch.profiler.record_function` range of its name, whose edges are the
profiler's own host events, on the clock of the device activity it records;
it syncs at its end on its own outputs, and makes its tracer the active one
while it is open. Module code then records into the active tracer:

- `span(name, sync)`: a timed range inside the stage, sampled alike;
- `count(name, value)`: a counter sample under `<stage>.<name>`, a number
  or a device tensor kept by reference and read once, by `summary()`;
- `host_read(value, read)`: a blocking read of the device, counted and
  timed under `<stage>.host_reads` / `<stage>.host_wait`.

With tracing off (the default) no tracer is active: a span returns a shared
null context, a counter records nothing, a host read is just `read(value)`,
and no range is opened.
"""

from __future__ import annotations

import contextlib
import contextvars
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch
from torch.profiler import record_function

_NULL = contextlib.nullcontext()
# the tracer whose traced stage is open, if any
_ACTIVE: contextvars.ContextVar = contextvars.ContextVar("rolo_tpu_torch_tracer", default=None)


def _synchronize(value) -> None:
    """Wait for the card when `value` (a tensor, or a tuple of them) lives
    there; nothing to wait for on the CPU."""
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            torch.cuda.synchronize(value.device)
    elif isinstance(value, (tuple, list)):
        for item in value:
            _synchronize(item)


def _values(samples: list) -> np.ndarray:
    """A counter's samples as one float64 vector: the device tensors among
    them concatenated where they lie and copied to the host once per
    (device, dtype)."""
    groups: Dict[tuple, List[torch.Tensor]] = {}
    host = []
    for x in samples:
        if isinstance(x, torch.Tensor):
            groups.setdefault((x.device, x.dtype), []).append(x.detach().reshape(-1))
        else:
            host.append(float(x))
    parts = [np.asarray(host, np.float64)]
    parts += [torch.cat(ts).cpu().numpy().astype(np.float64) for ts in groups.values()]
    return np.concatenate(parts)


class StageTimers:
    """Accumulates wall-clock samples per pipeline stage, and with `tracing`
    on the spans and counters of the module code the stages run.

    A stage without `sync` times the host's work: device work it enqueued
    and did not wait for lands in a later stage. `SequenceResult.wall_s`
    stays an end-to-end number."""

    def __init__(self) -> None:
        self._samples: Dict[str, list] = defaultdict(list)
        self._counters: set = set()
        self._open: List[str] = []  # the traced stages and spans open, outermost first
        self.tracing = False

    @contextlib.contextmanager
    def stage(self, name: str, sync=None) -> Iterator[None]:
        """Time a stage; with `sync` (a tensor, or a callable returning one)
        the time includes the card's work up to it. With `tracing` on, the
        stage is also a profiler range, and this tracer is the active one
        inside it (the way for any caller to collect a module's spans and
        counters: set `tracing`, then run the module inside a stage)."""
        if not self.tracing:
            t0 = time.perf_counter()
            try:
                yield
            finally:
                if sync is not None:
                    _synchronize(sync() if callable(sync) else sync)
                self._samples[name].append(time.perf_counter() - t0)
            return
        with self.activate(), self._range(name, sync):
            yield

    @contextlib.contextmanager
    def activate(self) -> Iterator["StageTimers"]:
        """Make this tracer the one `span`, `count` and `host_read` record
        into, inside the block."""
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

    @contextlib.contextmanager
    def _range(self, name: str, sync) -> Iterator[None]:
        self._open.append(name)
        t0 = time.perf_counter()
        try:
            with record_function(name):
                yield
                if sync is not None:
                    _synchronize(sync() if callable(sync) else sync)
        finally:
            self._samples[name].append(time.perf_counter() - t0)
            self._open.pop()

    def record(self, name: str, seconds: float) -> None:
        self._samples[name].append(seconds)

    def count(self, name: str, value) -> None:
        """A sample of the counter `name` (a number, or a tensor of them kept
        by reference), with tracing on."""
        if self.tracing:
            self._counters.add(name)
            self._samples[name].append(value)

    def _count_in_stage(self, name: str, value) -> None:
        if self._open:
            self.count(f"{self._open[0]}.{name}", value)

    def reset(self) -> None:
        """Drop the samples (to leave warm-up scans out of a measurement)."""
        self._samples.clear()

    def summary(self) -> Dict[str, Dict[str, float]]:
        """{stage or span: {count, mean_ms, p50_ms, p95_ms, max_ms, total_s}}
        and {counter: {count, mean, total, max}}, a counter's in its own unit
        over its values; names without samples are left out."""
        out = {}
        for name, xs in self._samples.items():
            if not xs:
                continue
            if name in self._counters:
                a = _values(xs)
                if not a.size:
                    continue
                out[name] = {"count": int(a.size), "mean": float(a.mean()),
                             "total": float(a.sum()), "max": float(a.max())}
                continue
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
        """The timed entries, most total time first."""
        rows = sorted(((k, s) for k, s in self.summary().items() if "total_s" in s),
                      key=lambda kv: -kv[1]["total_s"])
        lines = [f"{'stage':24s} {'count':>7s} {'mean':>9s} {'p95':>9s} {'total':>9s}"]
        for name, s in rows:
            lines.append(f"{name:24s} {s['count']:7d} {s['mean_ms']:7.2f}ms "
                         f"{s['p95_ms']:7.2f}ms {s['total_s']:8.2f}s")
        return "\n".join(lines)


def tracing() -> bool:
    """Whether a tracer is active: the guard for work done only to count."""
    return _ACTIVE.get() is not None


def span(name: str, sync=None):
    """A timed range of the active tracer (a stage's, see `StageTimers`),
    with `sync` as a stage's; a shared null context when none is active."""
    tracer = _ACTIVE.get()
    if tracer is None:
        return _NULL
    return tracer._range(name, sync)


def count(name: str, value) -> None:
    """A sample of the counter `<stage>.<name>` in the active tracer, the
    stage being the outermost one open; nothing when none is active."""
    tracer = _ACTIVE.get()
    if tracer is not None:
        tracer._count_in_stage(name, value)


def host_read(value, read=bool):
    """`read(value)`, a read that waits for the card (`bool` of a device
    flag, `torch.Tensor.tolist`, an event's `synchronize`). In the active
    tracer it counts one read under `<stage>.host_reads` and its wall time
    in seconds under `<stage>.host_wait`."""
    tracer = _ACTIVE.get()
    if tracer is None:
        return read(value)
    t0 = time.perf_counter()
    out = read(value)
    tracer._count_in_stage("host_wait", time.perf_counter() - t0)
    tracer._count_in_stage("host_reads", 1)
    return out


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
