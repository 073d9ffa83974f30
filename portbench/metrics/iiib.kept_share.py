"""iiib.kept_share: IIIB's useful-work ratio, the list entries its
threshold kept (``JoinStats.list_entries``) over the superset index's
entries for every R block of every join in the window, %."""


def read(run):
    c = run.counters
    total = c.get("joins", 0) * c.get("r_blocks", 0) * c.get("superset_entries", 0)
    kept = c["stats"].list_entries if "stats" in c else 0
    return 100.0 * kept / total if total and kept else None
