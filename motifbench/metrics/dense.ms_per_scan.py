"""The dense path's device time per traced scan, in ms: what
``ops/multi.py::dense_core`` launches for each motif longer than the
prefilter's rows (K1's exact scores of every window start, then the
threshold's mask, count and compaction), re-runs included."""

CALLERS = (r"multi\.py\(\d+\): dense_core$",)


def read(run):
    return run.trace.ms_per_scan(callers=CALLERS) if run.trace else None
