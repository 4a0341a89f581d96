"""Hits kept per candidate over the traced scans (the ``kept`` and
``candidates`` counts of the program's ``fetch`` spans): the useful
outcomes of the prefilter's attempts."""

from motifbench import spans


def read(run):
    scans = spans.traced_scans(run)
    kept = spans.count_total(scans, "fetch", "kept")
    candidates = spans.count_total(scans, "fetch", "candidates")
    return kept / candidates if kept is not None and candidates else None
