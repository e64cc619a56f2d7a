"""Front-end polar CT translation LM (registration/rotgicp.py, lm.lm_translation_rebind) per
scan: the synced wall time of the `frontend.translation` span over the window, over the
`frontend` stage's scans, in ms. Traced runs only (`SlamSystem.sync_stages`)."""


def read(trace):
    timers = (trace or {}).get("timers", {})
    span, scans = timers.get("frontend.translation"), timers.get("frontend")
    if not span or not scans or not scans["count"]:
        return None
    return span["total_s"] * 1e3 / scans["count"]
