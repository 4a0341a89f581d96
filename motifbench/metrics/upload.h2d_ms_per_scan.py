"""The device's host-to-device copies per traced scan, in ms: the
sequence's upload and any other copy a scan makes to the card."""

KERNELS = (r"HtoD",)
CATS = ("gpu_memcpy",)


def read(run):
    return run.trace.ms_per_scan(KERNELS, cats=CATS) if run.trace else None
