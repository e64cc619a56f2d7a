"""Kernel K1 (ops/voxel_join.py -> csrc/keyed_sum.cu)'s share of
its roofline in the traced sub-window, in %: the least time the calls could
take (benchmark/roofline/keyed_sum.py against benchmark/roofline/peaks.py) over
the device time of the kernel's own functions. None where it did not run."""


def read(trace):
    return (trace or {}).get("rooflines", {}).get("keyed_sum")
