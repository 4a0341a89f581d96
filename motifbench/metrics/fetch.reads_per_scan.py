"""Reads of the card per traced scan (the ``reads`` count of the
program's ``fetch`` span): 1 in a steady scan, more with re-runs or
heads too short."""

from motifbench import spans


def read(run):
    scans = spans.traced_scans(run)
    total = spans.count_total(scans, "fetch", "reads")
    return None if total is None else total / len(scans)
