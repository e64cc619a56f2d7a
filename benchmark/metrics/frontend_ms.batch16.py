"""Front-end (frontend/odometry.py scan_step over the 16 logs) per scan index: the mean of the benchmark's own synced span around each batched
`frontend` call over the window, in ms."""


def read(trace):
    span = (trace or {}).get("spans", {}).get("frontend")
    return span["mean_ms"] if span and span["count"] else None
