"""Mapping (mapping/backend.py, scan2map.py) per mapping step: the mean synced wall time of StageTimers' `backend` stage over the
window (the traced run sets `SlamSystem.sync_stages`), in ms."""


def read(trace):
    stage = (trace or {}).get("timers", {}).get("backend")
    return stage["mean_ms"] if stage and stage["count"] else None
