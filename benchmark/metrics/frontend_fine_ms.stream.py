"""Front-end fine stage (registration/rotgicp.py: the fine voxel map and its CT translation LM)
per scan: the synced wall time of the `frontend.fine` span over the window, over the
`frontend` stage's scans, in ms. Traced runs only (`SlamSystem.sync_stages`)."""


def read(trace):
    timers = (trace or {}).get("timers", {})
    span, scans = timers.get("frontend.fine"), timers.get("frontend")
    if not span or not scans or not scans["count"]:
        return None
    return span["total_s"] * 1e3 / scans["count"]
