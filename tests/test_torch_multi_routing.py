"""The port's ``MultiScanner`` routing against the JAX package's.

The dense path for long motifs (the default limit and ``DENSE_M_LIMIT``
= 64), protein databases, forced segments and motif groups (with
``single_bucket``), unreachable thresholds, motif sets the prefilter
cannot take, and wildcard-driven scores: each database scan must give
the JAX ``MultiScanner``'s (motif, position, f32 bits) triples.
"""

import numpy as np
import pytest

import lightmotif_tpu as jlm
import lightmotif_tpu_torch as tlm
from lightmotif_tpu.scanner import MultiScanner as JaxMultiScanner
from lightmotif_tpu_torch import convert
from lightmotif_tpu_torch.scanner import MultiScanner

from .test_multi import make_motifs
from .torch_parity import bits, multi_triples, random_motifs, sequences


def _both(motifs, thresholds, jseq, tseq, scanner=None):
    pssms, ths = convert.motif_set(motifs, thresholds)
    ms = scanner or MultiScanner(pssms, thresholds=ths, device="cpu")
    got = multi_triples(ms.scan_arrays(tseq))
    want = multi_triples(JaxMultiScanner(motifs, jseq, thresholds).collect_arrays())
    return got, want, ms


@pytest.mark.parametrize("dense_limit", [None, 64])
def test_long_motifs_both_routes(monkeypatch, dense_limit):
    monkeypatch.setattr(JaxMultiScanner, "DENSE_M_LIMIT", dense_limit)
    monkeypatch.setattr(MultiScanner, "DENSE_M_LIMIT", dense_limit)
    rng = np.random.default_rng(77)
    motifs = random_motifs(rng, [15, 80])
    thresholds = [-8.0, -np.inf]  # every window of the long motif is a hit
    jseq, tseq = sequences(rng.integers(0, 4, size=5000))
    got, want, ms = _both(motifs, thresholds, jseq, tseq)
    assert got == want
    host = motifs[1].score_host(jseq)
    long_hits = [(p, s) for mo, p, s in got if mo == 1]
    assert long_hits == list(zip(range(len(host)), bits(host).tolist()))
    assert ms._route()["dense_idx"].tolist() == ([] if dense_limit is None else [1])
    # a sequence shorter than the long motif
    jt, tt = sequences(rng.integers(0, 4, size=40))
    got, want, _ = _both(motifs, thresholds, jt, tt)
    assert got == want and {mo for mo, _, _ in got} == {0}


def test_very_long_motifs_take_the_dense_path():
    # against the JAX package's sequential host oracle, which its dense
    # path equals bit for bit (its windows path at m = 257 is slow here)
    rng = np.random.default_rng(12)
    motifs = random_motifs(rng, [8, 129, 150, 200, 257, 12])
    thresholds = [p.score_distribution().score(1e-3) for p in motifs]
    jseq, tseq = sequences(rng.integers(0, 4, size=20_000))
    pssms, ths = convert.motif_set(motifs, thresholds)
    ms = MultiScanner(pssms, thresholds=ths, device="cpu")
    got = multi_triples(ms.scan_arrays(tseq))
    want = []
    for i, (p, t) in enumerate(zip(motifs, thresholds)):
        host = np.asarray(p.score_host(jseq))
        pos = np.nonzero(host >= np.float32(t))[0]
        want += [(i, int(q), int(b)) for q, b in zip(pos, bits(host[pos]))]
    assert got == want and {mo for mo, _, _ in got} >= {0, 1, 5}
    assert ms._route()["dense_idx"].tolist() == [1, 2, 3, 4]


def test_protein_database():
    rng = np.random.default_rng(21)
    motifs = random_motifs(rng, [5, 9, 14, 20, 27, 32, 33, 40], protein=True)
    thresholds = [p.score_distribution().score(1e-3) for p in motifs]
    jseq, tseq = sequences(rng.integers(0, 20, size=8000), protein=True)
    got, want, ms = _both(motifs, thresholds, jseq, tseq)
    assert got == want and len({mo for mo, _, _ in got}) >= 4
    assert ms._route()["dense_idx"].tolist() == [6, 7]  # m > 32


def test_forced_segments():
    rng = np.random.default_rng(5)
    motifs = make_motifs() + [p.reverse_complement() for p in make_motifs()]
    thresholds = [-10.0, -3.0, -5.0] * 2
    jseq, tseq = sequences(rng.integers(0, 4, size=60_000))
    pssms, ths = convert.motif_set(motifs, thresholds)
    ms = MultiScanner(pssms, thresholds=ths, device="cpu")
    ms.SEGMENT = 997
    got, want, _ = _both(motifs, thresholds, jseq, tseq, scanner=ms)
    assert got == want
    # hits whose windows straddle a seam
    seams = [p for mo, p, _ in got if p % 997 > 997 - len(pssms[mo])]
    assert len(seams) >= 10


@pytest.mark.parametrize("single_bucket", [False, True])
def test_forced_groups(monkeypatch, single_bucket):
    monkeypatch.setattr(MultiScanner, "GROUP_MOTIFS", 2)
    rng = np.random.default_rng(6)
    motifs = make_motifs() + [p.reverse_complement() for p in make_motifs()]
    motifs += random_motifs(rng, [20, 33])
    thresholds = [-10.0, -3.0, -5.0] * 2 + [-2.0, 0.0]
    jseq, tseq = sequences(rng.integers(0, 4, size=30_000))
    pssms, ths = convert.motif_set(motifs, thresholds)
    ms = MultiScanner(pssms, thresholds=ths, single_bucket=single_bucket, device="cpu")
    got, want, _ = _both(motifs, thresholds, jseq, tseq, scanner=ms)
    assert got == want and got
    m_maxes = [g["m_max"] for g in ms._groups]
    assert len(ms._groups) == 4
    assert (len(set(m_maxes)) == 1) == single_bucket


def test_unreachable_motifs_are_pruned(monkeypatch):
    monkeypatch.setattr(MultiScanner, "GROUP_MOTIFS", 3)
    rng = np.random.default_rng(8)
    motifs = make_motifs() + [p.reverse_complement() for p in make_motifs()]
    thresholds = [-10.0, 1e9, -5.0, 1e9, 1e9, -3.0]
    jseq, tseq = sequences(rng.integers(0, 4, size=30_000))
    got, want, ms = _both(motifs, thresholds, jseq, tseq)
    assert got == want and got
    assert len(ms._groups) == 1
    assert sorted(ms._groups[0]["ids"].tolist()) == [0, 2, 5]
    got, want, ms = _both(motifs, [1e9] * 6, jseq, tseq)
    assert got == want == [] and ms._groups == []


@pytest.mark.parametrize("widths", [[1, 1], [1, 6, 12]], ids=["all_m1", "with_m1"])
def test_one_row_motifs(widths):
    # a set of one-row motifs has no prefilter geometry (m_max < 2): the
    # JAX package runs its windows path there and the port its dense
    # path; next to longer motifs a one-row motif joins the group
    rng = np.random.default_rng(9)
    motifs = random_motifs(rng, widths)
    thresholds = [-10.0, -0.5, -6.0][: len(widths)]
    jseq, tseq = sequences(rng.integers(0, 4, size=10_000))
    got, want, ms = _both(motifs, thresholds, jseq, tseq)
    assert got == want and {mo for mo, _, _ in got} == set(range(len(widths)))
    if widths == [1, 1]:
        assert not ms._groups and ms._route()["dense_idx"].tolist() == [0, 1]
    else:
        assert len(ms._groups) == 1 and ms._route()["dense_idx"].size == 0


def test_wildcard_above_body_max_and_unreachable_fold():
    data = np.asarray([[2.0, -3.0, -3.0, -3.0, 0.0],
                       [-1.0, -1.0, -1.0, -1.0, 0.0]], np.float32)
    best3 = np.asarray([[2.0, -3.0, -3.0, -3.0, 0.0],
                        [-1.0, 3.0, -1.0, -1.0, 0.0],
                        [-2.0, -2.0, 1.0, -2.0, 0.0]], np.float32)
    best = float(np.float32(np.float32(2.0) + np.float32(3.0)) + np.float32(1.0))
    for mats, thresholds, text in (
            ([data], [1.5], "ACGTANCCGT"),  # only the wildcard window passes
            ([best3, best3], [best + 0.1, best], "ACTACGACTACT")):
        motifs = [jlm.ScoringMatrix(jlm.DNA, m) for m in mats]
        jseq, tseq = sequences(jlm.EncodedSequence.encode(text).data)
        got, want, _ = _both(motifs, thresholds, jseq, tseq)
        assert got == want and got
        ports = [tlm.ScoringMatrix(tlm.DNA, m) for m in mats]
        single = sorted((i, h.position, int(bits(h.score)))
                        for i, (p, t) in enumerate(zip(ports, thresholds))
                        for h in tlm.Scanner(p, tseq, threshold=t, device="cpu"))
        assert got == single


def test_timing_hook_sees_every_stage_and_changes_no_hit(monkeypatch):
    # the stage spans a profiled scan records (the timing hook's
    # successor), with the fetch's counts from its one read
    from torch.profiler import ProfilerActivity, profile

    from lightmotif_tpu_torch.utils import profiling

    monkeypatch.setattr(MultiScanner, "DENSE_M_LIMIT", 32)
    rng = np.random.default_rng(31)
    motifs = random_motifs(rng, [6, 9, 12, 20, 40, 70])
    thresholds = [p.score_distribution().score(1e-3) for p in motifs]
    _, tseq = sequences(rng.integers(0, 4, size=12_000))
    pssms, ths = convert.motif_set(motifs, thresholds)
    ms = MultiScanner(pssms, thresholds=ths, device="cpu")
    ms.SEGMENT = 5000
    want = multi_triples(ms.scan_arrays(tseq))
    with profile(activities=[ProfilerActivity.CPU]):
        assert multi_triples(ms.scan_arrays(tseq)) == want
    records = profiling.spans()
    root = records[-1].scan
    mine = [r for r in records if r.scan == root]
    names = {r.id: r.name for r in mine}
    stages = [r.name for r in mine if names.get(r.parent) == "scanner.dispatch"]
    assert stages == ["prefilter", "exact.compact", "exact.phase_c", "exact.pairs"] * 3 + [
        "dense", "dense"]
    (fetch,) = [r.counts for r in mine if r.name == "fetch"]
    windows = sum(r.counts["windows"] for r in mine if r.name == "prefilter")
    group, dense = fetch["by_group"][0], fetch["by_group"]["dense"]
    assert windows >= 12_000 - 20 + 1 and group["entries"] == 3 and dense["entries"] == 2
    assert group["candidates"] >= group["pairs"] >= group["kept"]
    assert group["kept"] + dense["kept"] == fetch["kept"] == len(want)
    assert dense["kept"] == sum(mo in (4, 5) for mo, _, _ in want) > 0
