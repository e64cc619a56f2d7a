"""Deskew increment (runtime/slam.py, `deskew_increment`: the ESKF's body rates and velocity
over the sweep) per scan: the mean synced wall time of the `features.deskew` span over the
window, in ms. Traced runs only (`SlamSystem.sync_stages`); None where the program has no such
span or deskew is off."""


def read(trace):
    span = (trace or {}).get("timers", {}).get("features.deskew")
    return span["mean_ms"] if span and span["count"] else None
