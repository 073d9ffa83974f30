"""engine.r_block_ms: the mean duration of the ``engine.r_block`` span
(``SparseKNNIndex.query``, one R block from padding to the result pull;
under the scheduler, one served batch), ms.  Read as ``.join``
and ``.serve``."""
from portbench.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "engine.r_block")
