"""serve.worker_wait_ms: the mean duration of the ``serve.worker_wait``
span (a batch's wait for the scheduler's one dispatch worker, from the
hand-off until its query starts; a span each try), ms."""
from portbench.readers import mean_span_ms


def read(run):
    return mean_span_ms(run, "serve.worker_wait")
