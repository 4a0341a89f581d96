"""The prefilter's share of its roofline, in %: the least time the card
could take for the traced scans' prefilter work (``work.prefilter_work``:
the one-hot int8 contraction over the motifs the prefilter scans, counted
from each record's window starts, the motifs' lengths and the alphabet
size alone) over the prefilter kernels' traced time."""

from motifbench import work

KERNELS = (r"^mma_kernel",)
CALLERS = (r"multi_kernel\.py\(\d+\): prefilter_any",)


def read(run):
    t = run.trace
    ops = t.select(KERNELS, CALLERS) if t else []
    if not ops:
        return None
    lengths = run.lengths[run.prefiltered]
    bound = sum(work.bound_seconds(*work.prefilter_work(n, lengths, run.k),
                                   work.PEAKS["int8_ops_per_s"]) for n in t.scan_bp)
    return 100.0 * bound / t.seconds(ops)
