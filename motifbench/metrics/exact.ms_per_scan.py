"""The exact stages' device time per traced scan, in ms: the candidates'
compaction, phase C and the pairs kernels (re-runs included)."""

KERNELS = (r"^phase_c_kernel", r"^row_offsets", r"^keep_pairs")
CALLERS = (r"multi\.py\(\d+\): compact_candidates$",
           r"multi_stages\.py\(\d+\): (phase_c_bits|pairs_rescore)$")


def read(run):
    return run.trace.ms_per_scan(KERNELS, CALLERS) if run.trace else None
