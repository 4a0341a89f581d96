"""The share of the traced scans' warpgroup prefilter operations that ran
on deep shapes, those the kernel takes by its loop of commit groups (past
8 k-steps a lane, or three or four byte planes): the ``deep_ops`` counts of
the program's ``prefilter`` spans over their ``issued_ops``."""

from motifbench import spans


def read(run):
    scans = spans.traced_scans(run)
    deep = spans.count_total(scans, "prefilter", "deep_ops")
    issued = spans.count_total(scans, "prefilter", "issued_ops")
    return deep / issued if deep is not None and issued else None
