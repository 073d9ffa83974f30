"""iiib.scatter_share: the share of the device's busy time spent in the
kernels of ``index_add_`` (IIIB's per-tile scatter), from the trace, %."""
from portbench.readers import INDEX_ADD_KERNELS


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0:
        return None
    secs, n = t.seconds_matching(INDEX_ADD_KERNELS)
    return 100.0 * secs / t.busy_s if n else None
