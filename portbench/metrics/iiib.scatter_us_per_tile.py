"""iiib.scatter_us_per_tile: the host's time a tile step of IIIB's scatter,
the ``iiib.scatter`` spans' durations (one span an S block around
``masked_tile_scores``' tile loop) over their ``tiles`` counters, us; set
beside the device's time a tile step, it says whether the loop is bound by
its launches."""


def read(run):
    spans = [e for e in run.spans
             if e["name"] == "iiib.scatter" and e["dur_ms"] is not None]
    tiles = sum(e["attrs"].get("tiles", 0) for e in spans)
    return 1e3 * sum(e["dur_ms"] for e in spans) / tiles if tiles else None
