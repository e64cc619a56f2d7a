"""Front-end LMs (registration/lm.py) per scan: the outer iterations of every LM call of the
front-end (the counter `frontend.lm_iterations`) over the window, over the `frontend` stage's
scans. Traced runs only (`SlamSystem.sync_stages`)."""


def read(trace):
    timers = (trace or {}).get("timers", {})
    iters, scans = timers.get("frontend.lm_iterations"), timers.get("frontend")
    if not iters or not scans or not scans["count"]:
        return None
    return iters["total"] / scans["count"]
