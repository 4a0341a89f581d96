"""The host blocked on the card per traced scan, in ms (median): the
program's spans ``fetch.wait``, each read's event synchronised."""

from motifbench import spans


def read(run):
    return spans.median_ms(spans.traced_scans(run), ("fetch.wait",))
