"""The 95th percentile of every scan's wall in the window, from the call
of ``scan_arrays`` on a host sequence to its hit arrays on the host."""

import statistics


def read(run):
    walls = [s["wall_s"] * 1e3 for s in run.scans]
    if len(walls) < 2:
        return None
    return statistics.quantiles(walls, n=100, method="inclusive")[94]
