"""Prior cycle (runtime/cycles.py, prior/*) per cycle: the mean synced wall time of StageTimers' `prior` stage over the
window (the traced run sets `SlamSystem.sync_stages`), in ms."""


def read(trace):
    stage = (trace or {}).get("timers", {}).get("prior")
    return stage["mean_ms"] if stage and stage["count"] else None
