"""The host's work on a record set around its scan, per traced scan, in
ms (median): the program's spans ``records.join`` (the records joined
with wildcard separators before the upload) and ``records.map`` (the hits
mapped back to records and local positions after the scan)."""

from motifbench import spans


def read(run):
    return spans.median_ms(spans.traced_scans(run), ("records.join", "records.map"))
