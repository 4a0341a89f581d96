"""The benchmark's span around a new scanner's first ``scan_arrays``:
routing and packing the database, the seed capacities and their
re-runs."""


def read(run):
    return run.spans["scanner.first_scan"]
