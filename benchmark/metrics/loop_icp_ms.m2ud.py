"""Loop verification's point-to-point ICP (loop/closure.py, `icp_point2point` inside
`verify_loop`) per candidate: the mean synced wall time of the `loop.icp` span over the window,
in ms. Traced runs only (`SlamSystem.sync_stages`); None where no candidate was verified or the
program has no such span."""


def read(trace):
    span = (trace or {}).get("timers", {}).get("loop.icp")
    return span["mean_ms"] if span and span["count"] else None
