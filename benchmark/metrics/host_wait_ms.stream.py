"""Runtime (runtime/profiling.py's `host_read` in every stage) per scan: the wall time the host
waited in the stages' blocking reads of the card (the counters `<stage>.host_wait`, in s) over
the window, over the `frontend` stage's scans, in ms. Traced runs only
(`SlamSystem.sync_stages`)."""


def read(trace):
    timers = (trace or {}).get("timers", {})
    scans = timers.get("frontend")
    waits = [v["total"] for k, v in timers.items() if k.endswith(".host_wait")]
    if not waits or not scans or not scans["count"]:
        return None
    return sum(waits) * 1e3 / scans["count"]
