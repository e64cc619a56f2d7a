"""Front-end LMs' lambda trials (registration/lm.py, `_lm_inner`): the share of the trials run
that an instance ran while still searching (the counters `frontend.lm_trials_used` over
`frontend.lm_trials`) over the window, in %. Traced runs only (`SlamSystem.sync_stages`)."""


def read(trace):
    timers = (trace or {}).get("timers", {})
    used, run = timers.get("frontend.lm_trials_used"), timers.get("frontend.lm_trials")
    if not used or not run or not run["total"]:
        return None
    return 100.0 * used["total"] / run["total"]
