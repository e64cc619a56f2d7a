"""Runtime (runtime/slam.py): the kernels the card ran in the traced
sub-window over the scans it holds, per scan."""


def read(trace):
    if not trace or not trace.get("units"):
        return None
    return trace["launches"] / trace["units"]
