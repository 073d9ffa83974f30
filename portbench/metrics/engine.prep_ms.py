"""engine.prep_ms: the mean duration of the ``engine.prep`` span (the first
phase of an R block in ``SparseKNNIndex.query``: padding, uploads and the
driver's R-side inputs), ms.  Read as ``.join``."""
from portbench.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "engine.prep")
