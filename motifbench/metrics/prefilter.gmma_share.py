"""The share of the traced scans' prefilter launches that went through
the warpgroup kernel: the ``gmma`` counts of the program's ``prefilter``
spans over the number of those spans (1.0 when every launch did)."""

from motifbench import spans


def read(run):
    scans = spans.traced_scans(run)
    gmma = spans.count_total(scans, "prefilter", "gmma")
    n = sum(r.name == "prefilter" for rs in scans for r in rs)
    return None if gmma is None or not n else gmma / n
