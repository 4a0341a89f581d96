"""The rate at which the warpgroup prefilter issues its int8 MMA
operations, in tera-operations a second: the ``issued_ops`` counts of the
program's ``prefilter`` spans over the traced scans (the operations of
every tile of 128 positions by 128 lanes it multiplies, padded depths and
both byte planes included) over the prefilter's traced device time."""

from motifbench import spans

KERNELS = (r"^gmma_prefilter",)
CALLERS = (r"multi_kernel\.py\(\d+\): prefilter_any",)


def read(run):
    t = run.trace
    ops = t.select(KERNELS, CALLERS) if t else []
    issued = spans.count_total(spans.traced_scans(run), "prefilter", "issued_ops")
    if not ops or not issued:
        return None
    return issued / t.seconds(ops) / 1e12
