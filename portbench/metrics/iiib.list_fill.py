"""iiib.list_fill: how full IIIB's superset lists are where its tile loop
walks them: the real list entries over the list slots multiplied and
scattered (tiles walked × the common list width M), summed over the
window's ``iiib.scatter`` spans (one an S block), %.  The rest of the
products and ``index_add_`` columns work on padding."""


def read(run):
    spans = [e["attrs"] for e in run.spans
             if e["name"] == "iiib.scatter" and "entries" in e["attrs"]]
    slots = sum(a["slots"] for a in spans)
    return 100.0 * sum(a["entries"] for a in spans) / slots if slots else None
