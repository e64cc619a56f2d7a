"""Kernel K2 (ops/knn_moments.py -> csrc/knn_moments.cu)'s share of
its roofline in the traced sub-window, in %: the least time the calls could
take (benchmark/roofline/knn_moments.py against benchmark/roofline/peaks.py) over
the device time of the kernel's own functions. None where it did not run."""


def read(trace):
    return (trace or {}).get("rooflines", {}).get("knn_moments")
