"""The fetch's host work per traced scan, in ms (median): the program's
span ``fetch`` less its ``fetch.wait`` spans, that is the sort's issue,
the settling and re-runs' host work, and the hits' copies."""

from motifbench import spans


def read(run):
    return spans.self_ms(spans.traced_scans(run), "fetch", "fetch.wait")
