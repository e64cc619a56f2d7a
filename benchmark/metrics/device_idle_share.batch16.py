"""Device idle share in the traced sub-window: 100 x (1 - the union of the
card's activity intervals / the sub-window's wall time), in %."""


def read(trace):
    if not trace or trace.get("window_s", 0) <= 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
