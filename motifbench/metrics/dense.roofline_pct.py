"""K1's share of its roofline on the dense path, in %: the least time the
card could take for the traced scans' dense motifs over the traced time
of the K1 launches that ``ops/multi.py::dense_core`` makes.

One dense motif of ``m`` residues scores the window starts of every
record (``n - m + 1`` in a record of ``n``, none across the separators):
it reads the records' residues once and writes 4 bytes a start, or adds
``m`` float32 cells a start, and its least time is the larger of the
bytes over HBM's rate and the adds over the float32 peak (``work.PEAKS``),
summed over the dense motifs and the traced scans.  The dense motifs are
those longer than the program's ``MultiScanner.dense_m_limit`` (each can
reach its threshold at a p-value threshold)."""

import re

import numpy as np

from motifbench import work

K1 = re.compile(r"^(score_kernel|legacy_kernel)")
CALLERS = (r"multi\.py\(\d+\): dense_core$",)


def least_seconds(records, lengths) -> float:
    """The least time of one dense launch of each motif of ``lengths``
    over the records of the lengths ``records``."""
    n = np.asarray(records, np.int64)
    sizes, counts = np.unique(np.asarray(lengths, np.int64), return_counts=True)
    starts = np.maximum(n[None, :] - sizes[:, None] + 1, 0).sum(axis=1)
    nbytes = float(n.sum()) + 4.0 * starts
    adds = sizes * starts.astype(np.float64)
    each = np.maximum(nbytes / work.PEAKS["hbm_bytes_per_s"],
                      adds / work.PEAKS["f32_flops_per_s"])
    return float((counts * each).sum())


def read(run):
    from lightmotif_tpu_torch.scanner import MultiScanner

    t = run.trace
    ops = [o for o in t.select(callers=CALLERS) if K1.search(o["name"])] if t else []
    if not ops:
        return None
    dense = run.lengths[run.lengths > MultiScanner.dense_m_limit(run.k)]
    bound = sum(least_seconds(n, dense) for n in t.scan_bp)
    return 100.0 * bound / t.seconds(ops)
