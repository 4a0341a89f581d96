"""Candidate window starts the prefilter passed to the exact stages per
traced scan (the ``candidates`` count of the program's ``fetch`` span,
from the counters of its read)."""

from motifbench import spans


def read(run):
    scans = spans.traced_scans(run)
    total = spans.count_total(scans, "fetch", "candidates")
    return None if total is None else total / len(scans)
