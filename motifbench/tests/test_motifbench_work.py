"""The prefilter's work is counted from the problem alone: window
starts, the live motifs' lengths and the alphabet size; the program's
packing of the database does not move it."""

from types import SimpleNamespace

import numpy as np
import pytest

from motifbench import harness, work


def test_count_by_hand():
    ops, nbytes = work.prefilter_work(100, [5, 10], 5)
    assert ops == 2 * 5 * (5 * 96 + 10 * 91)
    assert nbytes == 100 + 15 * 5 + 4 * 100
    assert work.prefilter_work(100, [5, 200], 5)[0] == 2 * 5 * 5 * 96  # no window
    assert work.prefilter_work(10, [5] * 4097, 5)[1] == 10 + 4097 * 25 + 4 * 10 * 3


def test_records_count_their_own_window_starts():
    """A record set's work is each record's window starts, none across
    its separators, and its records' bases once."""
    ops, nbytes = work.prefilter_work([3, 40, 7], [5, 10], 21)
    assert ops == 2 * 21 * (5 * (36 + 3) + 10 * 31)
    assert nbytes == 50 + 15 * 21 + 4 * 50
    assert work.prefilter_work([100], [5, 10], 5) == work.prefilter_work(100, [5, 10], 5)


def fake_trace(ms, bp):
    ops = [{"name": "mma_kernel<false, 1, 128, 8, false>", "cat": "kernel", "ts": 0.0,
            "dur": ms * 1e3, "callers": []}]
    t = SimpleNamespace(ops=ops, scan_bp=bp)
    t.select = lambda kernels=(), callers=(), cats=(): [o for o in ops if "mma" in o["name"]]
    t.seconds = lambda sel: sum(o["dur"] for o in sel) / 1e6
    return t


def test_roofline_reads_the_bound_over_the_traced_time():
    lengths = np.asarray([5, 10, 35])
    run = SimpleNamespace(trace=fake_trace(2.0, [1000, 1000]), lengths=lengths,
                          prefiltered=np.asarray([True, True, False]), k=5)
    ops, nbytes = work.prefilter_work(1000, [5, 10], 5)
    bound = 2 * work.bound_seconds(ops, nbytes, work.PEAKS["int8_ops_per_s"])
    assert harness.reader("prefilter.roofline_pct")(run) == pytest.approx(100 * bound / 2e-3)
    run.trace = None
    assert harness.reader("prefilter.roofline_pct")(run) is None


def test_packing_does_not_move_the_count(monkeypatch):
    """Pack one database as two groups and as many: the groups' byte
    planes and per-chunk rows change, the count the metric reads does
    not."""
    from lightmotif_tpu_torch import DNA, CountMatrix
    from lightmotif_tpu_torch.scanner import MultiScanner

    rng = np.random.default_rng(3)
    counts = [np.concatenate([rng.integers(0, 20, (m, 4)), np.zeros((m, 1), int)], axis=1)
              for m in (5, 6, 9, 12, 20, 31)]
    pssms = [CountMatrix(DNA, c).to_freq(0.1).to_weight(None).to_scoring() for c in counts]
    ths = [p.score_distribution().score(1e-3) for p in pssms]
    seen = []
    for group in (2048, 2):
        monkeypatch.setattr(MultiScanner, "GROUP_MOTIFS", group)
        sc = MultiScanner(pssms, thresholds=ths, device="cpu")
        groups = sc._pack()
        lengths = np.asarray([len(p) for p in sc.pssms])
        seen.append((len(groups), work.prefilter_work(20000, lengths, DNA.size)))
    assert seen[0][0] != seen[1][0]
    assert seen[0][1] == seen[1][1]
