"""Prior cycle's vehicle contact solve and patch (runtime/cycles.py, association.compute_prior)
per 5 Hz cycle: the mean synced wall time of the `prior.contact` span over the window, in ms.
Traced runs only (`SlamSystem.sync_stages`)."""


def read(trace):
    span = (trace or {}).get("timers", {}).get("prior.contact")
    return span["mean_ms"] if span and span["count"] else None
