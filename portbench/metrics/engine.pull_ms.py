"""engine.pull_ms: the mean duration of the ``engine.pull`` span (the last
phase of an R block in ``SparseKNNIndex.query``: the result pull, which
waits for the device, and the host work after it), ms.  Read as ``.join``."""
from portbench.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "engine.pull")
