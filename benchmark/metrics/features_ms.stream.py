"""Featurize (pointcloud/projection.py, features.py) per scan: the mean synced wall time of StageTimers' `project+features` stage over the
window (the traced run sets `SlamSystem.sync_stages`), in ms."""


def read(trace):
    stage = (trace or {}).get("timers", {}).get("project+features")
    return stage["mean_ms"] if stage and stage["count"] else None
