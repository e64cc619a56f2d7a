"""Prior cycle's vehicle contact LM (prior/vehicle.py, `solve_pose`) over the window: the share
of its iterations run as replays of a captured CUDA graph, 100 x the counter
`prior.contact_graph_iterations` over it plus `prior.contact_eager_iterations`, in %. Traced
runs only (`SlamSystem.sync_stages`); None where the program counts neither."""


def read(trace):
    timers = (trace or {}).get("timers", {})
    graph, eager = (timers.get(f"prior.contact_{p}_iterations") for p in ("graph", "eager"))
    total = sum(c["total"] for c in (graph, eager) if c)
    if not total:
        return None
    return 100.0 * (graph["total"] if graph else 0.0) / total
