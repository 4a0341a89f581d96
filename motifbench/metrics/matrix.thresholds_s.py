"""The benchmark's span around building the database's scoring matrices
(both strands) and their thresholds through the program's public chain."""


def read(run):
    return run.spans["matrix.thresholds"]
