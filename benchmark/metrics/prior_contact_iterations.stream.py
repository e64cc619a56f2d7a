"""Prior cycle's vehicle contact LM (prior/vehicle.py, `solve_pose`) per solve: the mean of the
counter `prior.contact_iterations`, the outer LM iterations each solve ran, over the window, in
iterations. Traced runs only (`SlamSystem.sync_stages`); None where the window solved nothing
or the program has no such counter."""


def read(trace):
    counter = (trace or {}).get("timers", {}).get("prior.contact_iterations")
    return counter["mean"] if counter and counter["count"] else None
