"""Runtime scheduler (runtime/slam.py's background queue): the mean number of scans a loop tick
or graph solve waited from its enqueue to its dispatch (the counter `scheduler.wait_scans`)
over the window. Traced runs only (`SlamSystem.sync_stages`)."""


def read(trace):
    wait = (trace or {}).get("timers", {}).get("scheduler.wait_scans")
    return wait["mean"] if wait and wait["count"] else None
