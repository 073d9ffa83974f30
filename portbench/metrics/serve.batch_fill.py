"""serve.batch_fill: the scheduler's mean batch fill over the window, rows
in a batch over its ``r_block`` (``ServeMetrics``' occupancy), %."""


def read(run):
    fill = run.counters.get("fill_mean")
    return None if fill is None else 100.0 * fill
