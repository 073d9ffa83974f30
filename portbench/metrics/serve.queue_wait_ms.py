"""serve.queue_wait_ms: the mean time a request waited from ``submit`` to
the assembly of its batch (``ServeMetrics``' queue-wait phase), ms."""


def read(run):
    wait = run.counters.get("queue_wait_mean_s")
    return None if wait is None else 1e3 * wait
