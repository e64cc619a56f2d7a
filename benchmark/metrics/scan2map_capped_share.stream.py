"""Mapping's scan-to-map Gauss-Newton (mapping/scan2map.py, backend.backend_step): the share of
mapping steps whose GN stopped at `scan2map_max_iterations` unconverged (the 0/1 counter
`backend.s2m_capped`) over the window, in %. Traced runs only (`SlamSystem.sync_stages`)."""


def read(trace):
    capped = (trace or {}).get("timers", {}).get("backend.s2m_capped")
    return 100.0 * capped["mean"] if capped and capped["count"] else None
