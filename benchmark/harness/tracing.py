"""The traced sub-window: torch.profiler (host and card) over a fixed span
of the window, reduced in memory to what the per-layer metrics and the
result line's `breakdown` read. No trace file is written.

- busy: the union of the device's activity intervals (kernels, copies,
  fills) inside the sub-window; `window_s` its wall length;
- launches: the kernels run in it;
- device_ops: device seconds by kernel name, most first;
- idle_gaps: the longest stretches with nothing on the device, each named
  by the innermost host operation open at its middle;
- kernel_s: device seconds of each hand-written kernel family.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Tuple

import torch

SPAN = "bench.subwindow"
# the hand-written kernels' function names in csrc/*.cu, by entry
KERNELS = {
    "knn_moments": ("knn_moments_kernel", "morton_kernel", "gather_kernel", "box_kernel"),
    "keyed_sum": ("join_kernel", "run_chunks_kernel", "run_totals_kernel"),
}


def base_name(name: str) -> str:
    """A demangled kernel name without its return type, namespaces,
    template arguments and parameters: `void (anonymous namespace)::f<int>(float*)`
    -> `f`."""
    head = name.replace("(anonymous namespace)::", "").strip()
    if head.startswith("void "):
        head = head[5:]
    head = head.split("(", 1)[0].split("<", 1)[0].strip()
    return head.rsplit("::", 1)[-1].strip()


def _own(name: str) -> bool:
    """A kernel of the program's csrc/: in the global or an anonymous
    namespace (PyTorch's own kernels live in at::, c10:: and the like)."""
    head = name.replace("(anonymous namespace)::", "").split("(", 1)[0].split("<", 1)[0]
    return "::" not in head


def _start_ns(e) -> int:
    return e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)


def _duration_ns(e) -> int:
    return e.duration_ns() if hasattr(e, "duration_ns") else int(e.duration_us() * 1000)


def _is_device(e) -> bool:
    return "CUDA" in str(e.device_type())


def _is_annotation(e) -> bool:
    """A host annotation (record_function) mirrored on the device's timeline."""
    return bool(getattr(e, "is_user_annotation", lambda: False)())


def _is_transfer(name: str) -> bool:
    return name.startswith("Memcpy") or name.startswith("Memset")


@contextlib.contextmanager
def profiled() -> Iterator[list]:
    """Profile the host and the card inside; the list it yields receives the
    profiler's raw events when the block ends."""
    from torch.profiler import ProfilerActivity, profile, record_function

    sink: list = []
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        with record_function(SPAN):
            yield sink
            if torch.cuda.is_available():
                torch.cuda.synchronize()
    sink.extend(prof.profiler.kineto_results.events())


def _merge(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[Tuple[int, int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def reduce_events(events, top: int = 10) -> Dict:
    """The sub-window's numbers from the profiler's raw events."""
    span = [e for e in events if not _is_device(e) and e.name() == SPAN]
    if not span:
        raise RuntimeError("the traced sub-window's span is missing from the profile")
    w0 = _start_ns(span[0])
    w1 = w0 + _duration_ns(span[0])
    device, host = [], []
    for e in events:
        s = _start_ns(e)
        d = _duration_ns(e)
        name = e.name()
        if _is_device(e):
            if name == SPAN or _is_annotation(e) or "Sync" in name or d <= 0:
                continue  # annotations and synchronization records, not device work
            device.append((name, max(s, w0), min(s + d, w1)))
        elif name not in (SPAN, "Activity Buffer Request") and d > 0:
            host.append((name, s, s + d))
    device = [(n, s, e) for n, s, e in device if e > s]
    busy = _merge([(s, e) for _, s, e in device])
    busy_ns = sum(e - s for s, e in busy)
    by_name: Dict[str, float] = {}
    kernel_s = {k: 0.0 for k in KERNELS}
    launches = 0
    for name, s, e in device:
        by_name[name] = by_name.get(name, 0.0) + (e - s) * 1e-9
        if not _is_transfer(name):
            launches += 1
        b = base_name(name)
        for fam, names in KERNELS.items():
            if b in names and _own(name):
                kernel_s[fam] += (e - s) * 1e-9
    gaps = []
    cursor = w0
    for s, e in busy + [(w1, w1)]:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for g0, g1 in gaps[:top]:
        mid = (g0 + g1) // 2
        open_ops = [(s, n) for n, s, e in host if s <= mid < e]
        named.append([max(open_ops)[1] if open_ops else "host idle", (g1 - g0) * 1e-9])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy_ns * 1e-9, "launches": launches,
            "device_ops": [[n, s] for n, s in ops], "idle_gaps": named, "kernel_s": kernel_s}
