"""The device's peak allocated memory over the window (the allocator's
``max_memory_allocated``, reset after set-up), in GiB."""


def read(run):
    return run.peak_bytes / 2**30
