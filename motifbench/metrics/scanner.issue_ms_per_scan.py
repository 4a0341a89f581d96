"""The host's issue of a scan, in ms (median over the traced scans): the
program's span ``scanner.dispatch``, every step queued eagerly."""

from motifbench import spans


def read(run):
    return spans.median_ms(spans.traced_scans(run), ("scanner.dispatch",))
