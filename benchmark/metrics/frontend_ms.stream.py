"""Front-end (frontend/odometry.py, registration/*, voxel/*) per scan: the mean synced wall time of StageTimers' `frontend` stage over the
window (the traced run sets `SlamSystem.sync_stages`), in ms."""


def read(trace):
    stage = (trace or {}).get("timers", {}).get("frontend")
    return stage["mean_ms"] if stage and stage["count"] else None
