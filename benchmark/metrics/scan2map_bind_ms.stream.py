"""Mapping's scan-to-map binds (mapping/scan2map.py `scan2map_optimize`: each (re)bind's
`corner_bind` + `surf_bind`, their 5-NN and fits) per mapping step: the synced wall time of the
`backend.bind` span summed over the window, over the `backend` stage's steps, in ms. Traced
runs only (`SlamSystem.sync_stages`); None where no step ran or the program has no such
span."""


def read(trace):
    timers = (trace or {}).get("timers", {})
    bind, steps = timers.get("backend.bind"), timers.get("backend")
    if not bind or not bind["count"] or not steps or not steps["count"]:
        return None
    return 1e3 * bind["total_s"] / steps["count"]
