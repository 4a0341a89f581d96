"""Re-runs at ratcheted capacities (the program's counter
``ops.multi.RERUNS``, groups and dense motifs) per scan of the window."""


def read(run):
    return run.counters["reruns"] / len(run.scans) if run.scans else None
