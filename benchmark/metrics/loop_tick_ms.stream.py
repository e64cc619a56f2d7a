"""Loop tick (loop/*, backend.loop_closure_step) per tick: the mean synced wall time of StageTimers' `loop_closure` stage over the
window (the traced run sets `SlamSystem.sync_stages`), in ms."""


def read(trace):
    stage = (trace or {}).get("timers", {}).get("loop_closure")
    return stage["mean_ms"] if stage and stage["count"] else None
