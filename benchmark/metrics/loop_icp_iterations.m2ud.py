"""Loop verification's ICP iterations (loop/closure.py, `icp_point2point`'s host loop) per
candidate: the counter `loop_closure.icp_iterations` over the window, over the counter
`loop_closure.candidates`. Traced runs only (`SlamSystem.sync_stages`); None where no candidate
was verified or the program counts neither."""


def read(trace):
    timers = (trace or {}).get("timers", {})
    iters, cands = timers.get("loop_closure.icp_iterations"), timers.get("loop_closure.candidates")
    if not iters or not cands or not cands["total"]:
        return None
    return iters["total"] / cands["total"]
