"""The card's idle time per traced scan that falls inside the program's
spans but outside ``fetch.wait``, in ms: the card waiting on the
program's own host work (the spans laid on the trace's clock by each
scan's ``scan_arrays`` call)."""

from motifbench import spans


def read(run):
    return spans.host_idle_ms(run.trace, spans.traced_scans(run))
