"""Process start to the first timed scan: imports, the kernel libraries
(from the build cache after a cell's first run), the inputs made from the
seed, the matrix chain and thresholds, and the scanner's first scan of
every sequence."""


def read(run):
    return run.setup_s
