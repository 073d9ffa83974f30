"""What the per-layer readers (``metrics/<name>.py``) share.

A reader is one function, ``read(run)``, that takes a finished traced run
(``run.Run``: its spans, launch counters, the traffic's counters, the
device trace, the inputs) and returns the metric's value, or ``None``
when it finds nothing to read; the harness then leaves the metric out of
the line.  A share of a roofline or of a peak is never 0: a reader that
finds no time or no work returns ``None``.
"""
from __future__ import annotations

import numpy as np

from portbench import work

# device operations by name (the CUDA kernels' names in the trace)
KNN_TOPK_KERNELS = r"knn_topk_(select|merge)"
TOPK_MERGE_KERNELS = r"(?<!knn_)topk_merge_(split_|large_)?kernel"
INDEX_ADD_KERNELS = r"indexFunc|index_add"


def mean_span_ms(run, name: str):
    """The mean duration in ms of the window's spans called ``name``."""
    durs = [e["dur_ms"] for e in run.spans if e["name"] == name and e["dur_ms"] is not None]
    return float(np.mean(durs)) if durs else None


def idle_share(run):
    """The share of the traced window in which nothing ran on the device, %."""
    t = run.trace
    if t is None or t.busy_s <= 0 or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def join_flops(run) -> float:
    """The FLOPs one join of the run's R against its S needs."""
    dim = run.config["dim"]
    return work.join_flops(run.R[0], run.S[0], dim)


def roofline(bound_s: float, device_s: float):
    """A bound over the device time it was measured against, %."""
    if bound_s <= 0 or device_s <= 0:
        return None
    return 100.0 * bound_s / device_s
