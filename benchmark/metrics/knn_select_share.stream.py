"""Mapping's k-NN selection (voxel/knn.py `knn_indices`: the scan-to-map binds, the loop and
prior ICPs) over the window: the share of its calls served by kernel K3 (ops/knn_select.py),
100 x the counters `<stage>.knn.kernel_calls` over them plus `<stage>.knn.plain_calls`, summed
over stages, in %. Traced runs only (`SlamSystem.sync_stages`); None where the program counts
neither."""


def read(trace):
    timers = (trace or {}).get("timers", {})

    def calls(kind):
        return sum(c["total"] for name, c in timers.items()
                   if name == f"knn.{kind}_calls" or name.endswith(f".knn.{kind}_calls"))

    kernel, plain = calls("kernel"), calls("plain")
    if not kernel + plain:
        return None
    return 100.0 * kernel / (kernel + plain)
