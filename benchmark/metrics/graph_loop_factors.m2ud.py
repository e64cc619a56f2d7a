"""Live loop factors per graph solve (mapping/backend.py, `solve_graph_host`): the mean of the
counter `graph_solve.loop_factors` over the window's solves, the load that `graph_solve_ms`
grows with. Traced runs only (`SlamSystem.sync_stages`); None where the window solved nothing or
the program has no such counter."""


def read(trace):
    counter = (trace or {}).get("timers", {}).get("graph_solve.loop_factors")
    return counter["mean"] if counter and counter["count"] else None
