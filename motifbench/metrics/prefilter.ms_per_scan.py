"""The database prefilter's device time per traced scan, in ms (K3, or
K5 / K4 where the routing chose them, re-runs included)."""

KERNELS = (r"^mma_kernel",)
CALLERS = (r"multi_kernel\.py\(\d+\): prefilter_any",)


def read(run):
    return run.trace.ms_per_scan(KERNELS, CALLERS) if run.trace else None
