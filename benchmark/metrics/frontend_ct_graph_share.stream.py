"""Front-end CT translation LMs (registration/lm.py, `lm_translation`) over the window: the share
of their outer iterations run as replays of a captured CUDA graph, 100 x the counter
`frontend.ct_graph_iterations` over it plus `frontend.ct_eager_iterations`, in %. Traced runs
only (`SlamSystem.sync_stages`); None where the program counts neither."""


def read(trace):
    timers = (trace or {}).get("timers", {})
    graph, eager = (timers.get(f"frontend.ct_{p}_iterations") for p in ("graph", "eager"))
    total = sum(c["total"] for c in (graph, eager) if c)
    if not total:
        return None
    return 100.0 * (graph["total"] if graph else 0.0) / total
