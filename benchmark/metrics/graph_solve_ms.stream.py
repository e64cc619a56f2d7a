"""Graph solve (graph/solver.py, backend.solve_graph_host) per solve: the
mean wall time of StageTimers' `graph_solve` stage over the window, in ms.
The stage takes no sync of its own; its Gauss-Newton loop reads the host
every iteration, so all but its last update lands inside it."""


def read(trace):
    stage = (trace or {}).get("timers", {}).get("graph_solve")
    return stage["mean_ms"] if stage and stage["count"] else None
