"""The card's published peaks and the work a layer's problem asks for,
counted from the problem's shapes alone (never from how the program
packs it), for the roofline shares of ``metrics/``.
"""

from __future__ import annotations

import numpy as np

#: NVIDIA H100 SXM data sheet, dense rates at its 700 W limit.
PEAKS = {"int8_ops_per_s": 1979e12, "bf16_flops_per_s": 989e12,
         "f32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}

#: Motif lanes a prefilter group's output covers: the JAX package's
#: group of 2,048 motifs, whose one int32 maximum a window start the
#: prefilter writes (hits do not depend on it).
GROUP_LANES = 2048


def prefilter_work(n, lengths, k: int) -> tuple:
    """``(operations, bytes)`` of the database prefilter over a sequence
    of ``n`` bases, or over the records of a set whose lengths ``n``
    lists, for the motifs of ``lengths`` that it scans: the one-hot int8
    contraction that the JAX kernel is written as, 2 x k operations per
    motif column and window start (``n - m + 1`` of them in each record,
    none across the records' separators); the records read once, one
    byte per discrete cell of the motifs, and 4 bytes out per window
    start and group of :data:`GROUP_LANES` motifs."""
    n = np.atleast_1d(np.asarray(n, np.int64))
    sizes, counts = np.unique(np.asarray(lengths, np.int64), return_counts=True)
    starts = np.maximum(n[None, :] - sizes[:, None] + 1, 0).sum(axis=1)
    ops = 2.0 * k * float((counts * sizes * starts).sum())
    groups = -(-int(counts.sum()) // GROUP_LANES)
    bases = float(n.sum())
    nbytes = bases + float((counts * sizes).sum()) * k + 4.0 * bases * groups
    return ops, nbytes


def bound_seconds(ops: float, nbytes: float, ops_per_s: float) -> float:
    """The least time the card could take: the larger of the operations
    over their peak and the bytes over HBM's rate."""
    return max(ops / ops_per_s, nbytes / PEAKS["hbm_bytes_per_s"])
