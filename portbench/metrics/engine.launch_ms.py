"""engine.launch_ms: the mean duration of the ``engine.launch`` span (an R
block's warm-start pass and driver call, up to the return of its last
enqueue), ms.  Read as ``.join``."""
from portbench.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "engine.launch")
