"""Mapping (mapping/backend.py backend_step over the 16 logs) per mapping step: the mean of the benchmark's own synced span around each batched
`backend` call over the window, in ms."""


def read(trace):
    span = (trace or {}).get("spans", {}).get("backend")
    return span["mean_ms"] if span and span["count"] else None
