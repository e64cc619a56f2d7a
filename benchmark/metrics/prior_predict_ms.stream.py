"""Prior cycle's ESKF rollout (runtime/cycles.py, fusion.predict_future) per 5 Hz cycle: the
mean synced wall time of the `prior.predict` span over the window, in ms. Traced runs only
(`SlamSystem.sync_stages`)."""


def read(trace):
    span = (trace or {}).get("timers", {}).get("prior.predict")
    return span["mean_ms"] if span and span["count"] else None
