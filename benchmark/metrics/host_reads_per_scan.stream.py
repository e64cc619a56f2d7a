"""Runtime (runtime/profiling.py's `host_read` in every stage) per scan: the blocking reads of
the card by the program's stages (the counters `<stage>.host_reads`) over the window, over the
`frontend` stage's scans. Traced runs only (`SlamSystem.sync_stages`)."""


def read(trace):
    timers = (trace or {}).get("timers", {})
    scans = timers.get("frontend")
    reads = [v["total"] for k, v in timers.items() if k.endswith(".host_reads")]
    if not reads or not scans or not scans["count"]:
        return None
    return sum(reads) / scans["count"]
