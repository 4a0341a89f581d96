"""The device's device-to-host copies per traced scan, in ms: the hits'
counters, heads and tails read by the fetch."""

KERNELS = (r"DtoH",)
CATS = ("gpu_memcpy",)


def read(run):
    return run.trace.ms_per_scan(KERNELS, cats=CATS) if run.trace else None
