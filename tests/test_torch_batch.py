"""The port's batched records (``lightmotif_tpu_torch.batch``) against the
JAX package's ``lightmotif_tpu.batch``, on the cases of
``tests/test_batch.py``: per-record hits of ``BatchScanner``,
``BatchReducer``'s (max, argmax) with its tie rules, short records,
pinned and ratcheting geometry, and ``MultiBatchScanner`` with pipelined
``dispatch``/``fetch`` across a rebind, on DNA and on a protein database
(one strand, a non-uniform background, motifs on the dense path, records
shorter than the longest motif).  Positions are equal and f32 scores
equal bit for bit.  The protein record hits are also held to the
benchmark's plain reference (``motifbench/reference.py``).
"""

import json
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import lightmotif_tpu as jlm
import lightmotif_tpu_torch as tlm
from lightmotif_tpu import batch as jbatch
from lightmotif_tpu_torch import batch, convert

from .data import build_pssm
from .test_multi import make_motifs
from .torch_parity import bits, hit_keys, random_counts

ROOT = Path(__file__).resolve().parents[1]

#: Swiss-Prot's amino-acid composition over ``ACDEFGHIKLMNPQRSTVWY``, 0
#: for ``X``, whose float32 sum is 1 (the benchmark's protein background).
PROTEIN_BG = json.loads((ROOT / "motifbench/configs/prints42-human.json").read_text())[
    "database"]["background"]


def _port(jp):
    return convert.motif_set([jp])[0][0]


def _records(rng, n, lo=40, hi=400):
    """The same random DNA records in both packages: (jax, torch)."""
    data = [rng.integers(0, 4, size=int(rng.integers(lo, hi)), dtype=np.uint8)
            for _ in range(n)]
    return ([jlm.EncodedSequence(d) for d in data],
            [tlm.EncodedSequence(d.copy()) for d in data])


def _same_lists(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert hit_keys(g) == hit_keys(w)


@pytest.mark.parametrize("threshold,sizes", [(-12.0, None), (-30.0, (3, 15, 200, 14, 60))],
                         ids=["random", "short_records"])
def test_batch_scanner_matches_jax_and_per_record(threshold, sizes):
    rng = np.random.default_rng(6)
    jp = build_pssm()
    tp = _port(jp)
    if sizes is None:
        jrec, trec = _records(rng, 25)
    else:
        data = [rng.integers(0, 4, size=n, dtype=np.uint8) for n in sizes]
        jrec = [jlm.EncodedSequence(d) for d in data]
        trec = [tlm.EncodedSequence(d.copy()) for d in data]
    got = batch.BatchScanner(tp, trec, threshold=threshold, device="cpu").collect()
    _same_lists(got, jbatch.BatchScanner(jp, jrec, threshold=threshold).collect())
    _same_lists(got, [tlm.Scanner(tp, s, threshold=threshold, device="cpu").collect()
                      for s in trec])
    assert sum(map(len, got)) > 0
    if sizes is not None:
        assert got[0] == [] and got[3] == []  # shorter than the motif


def _reduced(reducer):
    mx = reducer.max()
    am, sc = reducer.argmax()
    assert np.array_equal(bits(mx), bits(sc))
    assert am.dtype == np.int64 and mx.dtype == np.float32
    return am.tolist(), bits(mx).tolist()


def test_batch_reducer_matches_jax_ties_and_short_records():
    rng = np.random.default_rng(21)
    jp = build_pssm()
    tp = _port(jp)
    jrec, trec = _records(rng, 40, lo=10, hi=600)
    best = "GTTGACCTTATCAAC"  # one record repeating the same best window
    jrec.append(jlm.EncodedSequence.encode(best + "AC" + best + best))
    trec.append(tlm.EncodedSequence.encode(best + "AC" + best + best))
    short = rng.integers(0, 4, size=6, dtype=np.uint8)  # shorter than the motif
    jrec.append(jlm.EncodedSequence(short))
    trec.append(tlm.EncodedSequence(short.copy()))
    got = _reduced(batch.BatchReducer(tp, trec, device="cpu"))
    assert got == _reduced(jbatch.BatchReducer(jp, jrec))
    am, mx = got
    assert am[-1] == -1 and mx[-1] == bits(-np.inf)
    host = tp.score_host(trec[-2])
    assert am[-2] == int(np.nonzero(host == host.max())[0][-1])  # the last tie


def test_batch_reducer_all_neginf_record_lands_on_the_last_valid_start():
    pssms = []
    for lm in (jlm, tlm):
        cm = lm.CountMatrix.from_sequences(
            [lm.EncodedSequence.encode("AAAA"), lm.EncodedSequence.encode("AAAA")])
        pssms.append(cm.to_freq(0.0).to_scoring(None))  # -inf off-consensus
    records = ["CCCCCCCCCC", "CCAAAACC"]
    want = _reduced(jbatch.BatchReducer(
        pssms[0], [jlm.EncodedSequence.encode(r) for r in records]))
    got = _reduced(batch.BatchReducer(
        pssms[1], [tlm.EncodedSequence.encode(r) for r in records], device="cpu"))
    assert got == want
    assert got[0][0] == 10 - 4 and got[1][0] == bits(-np.inf)


def test_batch_reducer_pinned_geometry_and_ratchet():
    rng = np.random.default_rng(33)
    jp = build_pssm()
    tp = _port(jp)
    m = len(tp)
    br = batch.BatchReducer(tp, slot=64 + m - 1, n_slots=8, device="cpu")
    jr = jbatch.BatchReducer(jp, slot=64 + m - 1, n_slots=8)
    for n in (8, 5):  # fewer records the second time: the geometry holds
        jrec, trec = _records(rng, n, lo=m, hi=64)
        assert _reduced(br.rebind(trec)) == _reduced(jr.rebind(jrec))
        assert (br.slot, br.n) == (64 + m - 1, 8)
    with pytest.raises(ValueError, match="pinned"):
        br.rebind(_records(rng, 3, lo=200, hi=300)[1])
    # one pinned dimension: the other ratchets (it only grows)
    br = batch.BatchReducer(tp, n_slots=8, device="cpu")
    jr = jbatch.BatchReducer(jp, n_slots=8)
    for lo, hi in ((m, 40), (m, 30), (100, 120)):
        jrec, trec = _records(rng, 4, lo=lo, hi=hi)
        assert _reduced(br.rebind(trec)) == _reduced(jr.rebind(jrec))
        assert (br.slot, br.n) == (jr.slot, jr.n)
    with pytest.raises(ValueError):
        br.rebind(_records(rng, 9, lo=m, hi=40)[1])
    br = batch.BatchReducer(tp, slot=60 + m - 1, device="cpu")
    assert br.rebind(_records(rng, 3, lo=m, hi=60)[1]).max().shape == (3,)
    with pytest.raises(ValueError):
        br.rebind(_records(rng, 2, lo=100, hi=120)[1])


def _multi_db():
    rng = np.random.default_rng(8)
    motifs = []
    for width in (6, 15):
        sites = ["".join("ACTG"[j] for j in rng.integers(0, 4, size=width))
                 for _ in range(4)]
        cm = jlm.CountMatrix.from_sequences(jlm.EncodedSequence.encode(s) for s in sites)
        motifs.append(cm.to_freq(0.1).to_weight(None).to_scoring())
    return rng, motifs, convert.motif_set(motifs)[0]


def _arrays_equal(got, want):
    assert len(got) == len(want) == 4
    for a, b in zip(got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


#: Protein motif widths: the prefilter's up to 32 rows, the dense path past
#: them; and protein record lengths, some shorter than the longest motif.
PROTEIN_WIDTHS = (5, 9, 13, 20, 26, 32, 33, 40)
PROTEIN_RECORDS = (3, 17, 39, 41, 120, 333, 800, 1500, 64, 250)


def _protein_records(rng, lengths=PROTEIN_RECORDS):
    """Proteins drawn from :data:`PROTEIN_BG` (no ``X``), as rank arrays."""
    freqs = np.asarray(PROTEIN_BG[:20], np.float64)
    return [rng.choice(20, size=n, p=freqs / freqs.sum()).astype(np.uint8) for n in lengths]


def _protein_db():
    """Protein motifs of :data:`PROTEIN_WIDTHS` against :data:`PROTEIN_BG`,
    one strand, thresholds at p = 1e-3, and proteins of
    :data:`PROTEIN_RECORDS`: ``(jax motifs, port motifs, thresholds,
    jax records, port records)``."""
    rng = np.random.default_rng(31)
    bg = jlm.Background(jlm.PROTEIN, np.asarray(PROTEIN_BG, np.float32))
    jmotifs = [jlm.CountMatrix(jlm.PROTEIN, random_counts(rng, w, 21)).to_freq(0.1)
               .to_weight(bg).to_scoring() for w in PROTEIN_WIDTHS]
    tmotifs, ths = convert.motif_set(
        jmotifs, [p.score_distribution().score(1e-3) for p in jmotifs])
    data = _protein_records(rng)
    return (jmotifs, tmotifs, ths, [jlm.EncodedSequence(d, jlm.PROTEIN) for d in data],
            [tlm.EncodedSequence(d.copy(), tlm.PROTEIN) for d in data])


@pytest.mark.parametrize("alphabet", ["dna", "protein"])
def test_multi_batch_scanner_matches_jax(alphabet):
    from lightmotif_tpu_torch.scanner import MultiScanner

    if alphabet == "dna":
        rng, jmotifs, tmotifs = _multi_db()
        jrec, trec = _records(rng, 12)
        ths = -8.0
    else:
        jmotifs, tmotifs, ths, jrec, trec = _protein_db()
        assert max(PROTEIN_WIDTHS) > MultiScanner.dense_m_limit(21) >= min(PROTEIN_WIDTHS)
        assert min(PROTEIN_RECORDS) < max(PROTEIN_WIDTHS)
    tb = batch.MultiBatchScanner(tmotifs, trec, thresholds=ths, device="cpu")
    jb = jbatch.MultiBatchScanner(jmotifs, jrec, thresholds=ths)
    _arrays_equal(tb.collect_arrays(), jb.collect_arrays())
    got, want = tb.collect(), jb.collect()
    assert sum(map(len, got)) > 0
    for g, w in zip(got, want):
        assert [(h.motif, h.position, int(bits(h.score))) for h in g] == \
               [(h.motif, h.position, int(bits(h.score))) for h in w]
    if alphabet == "protein":  # hits of both routes
        motifs = {h.motif for hits in got for h in hits}
        assert min(motifs) < 6 and max(motifs) >= 6
    # and each record's hits are its own MultiScanner's
    for s, hits in zip(trec, got):
        own = MultiScanner(tmotifs, s, thresholds=ths, device="cpu").collect()
        assert [(h.motif, h.position, h.score) for h in hits] == \
               [(h.motif, h.position, h.score) for h in own]


def test_protein_record_hits_match_the_plain_reference():
    # the port's chain and record hits against the benchmark's plain
    # reference (plain NumPy and PyTorch, nothing of the port or of JAX),
    # judged as the benchmark's check judges a cell, at its limits
    sys.path.insert(0, str(ROOT))
    try:
        from motifbench import check, reference
    finally:
        sys.path.remove(str(ROOT))
    limits = json.loads((ROOT / "motifbench/limits/human.proteome-p1e-4.json").read_text())
    rng = np.random.default_rng(44)
    counts = [random_counts(rng, w, 21).astype(np.uint32) for w in PROTEIN_WIDTHS]
    freqs = np.asarray(PROTEIN_BG, np.float32)
    bg = tlm.Background(tlm.PROTEIN, freqs)
    pssms = [tlm.CountMatrix(tlm.PROTEIN, c).to_freq(0.1).to_weight(bg).to_scoring()
             for c in counts]
    ths = np.asarray([p.score_distribution().score(1e-3) for p in pssms], np.float32)
    records = _protein_records(rng)
    hits = batch.MultiBatchScanner(
        pssms, [tlm.EncodedSequence(r, tlm.PROTEIN) for r in records], thresholds=ths,
        device="cpu").collect_arrays()
    mats = reference.scoring_matrices(counts, 0.1, freqs.astype(np.float64))
    t_ref = reference.thresholds(mats, freqs.astype(np.float64), 1e-3, "cpu")
    assert check.matrix_gap([p.data for p in pssms], mats) <= limits["matrix_gap"]
    assert check.threshold_gap(ths, t_ref) <= limits["threshold_gap"]
    windows = reference.Windows(mats, 21, 20, "cpu")
    codes, offsets, lengths = reference.join_records(
        records, int(windows.lengths.max()) - 1, 20)
    *placed, misplaced = check.place_hits(hits, offsets, lengths, windows.lengths)
    got = check.judge_hits(windows, torch.from_numpy(codes), placed, t_ref, ths,
                           limits["score_gap"])
    assert misplaced == 0 and got["hits"] == len(hits[0]) > 0
    assert got["missed_hits"] == got["extra_hits"] == 0, got
    assert got["score_gap"] <= limits["score_gap"]


def test_multi_batch_dispatch_fetch_pipelined_across_a_rebind():
    jp = build_pssm()
    motifs = make_motifs()
    tmotifs = convert.motif_set(motifs)[0]
    rng = np.random.default_rng(3)
    flights = [_records(rng, 3, lo=250, hi=700) for _ in range(3)]
    thresholds = [-10.0, -3.0, -5.0]
    tb = batch.MultiBatchScanner(tmotifs, thresholds=thresholds, device="cpu")
    want = [jbatch.MultiBatchScanner(motifs, jr, thresholds, pad_to=4096).collect_arrays()
            for jr, _ in flights]
    # a token in flight while the next batch is prepared, bound and dispatched
    got, pending = [], None
    for _, tr in flights:
        token = tb.rebind_prepared(tb.prepare(tr, pad_to=4096)).dispatch()
        if pending is not None:
            got.append(tb.fetch(pending))
        pending = token
    got.append(tb.fetch(pending))
    for g, w in zip(got, want):
        _arrays_equal(g, w)
    assert sum(len(g[0]) for g in got) > 0
    # single-motif database too, through rebind
    tb1 = batch.MultiBatchScanner([_port(jp)], thresholds=-8.0, device="cpu")
    jb1 = jbatch.MultiBatchScanner([jp], thresholds=-8.0)
    for jr, tr in flights:
        _arrays_equal(tb1.rebind(tr, pad_to=2048).collect_arrays(),
                      jb1.rebind(jr, pad_to=2048).collect_arrays())


def test_unbound_batches_raise():
    rng, _, tmotifs = _multi_db()
    with pytest.raises(ValueError, match="no records bound"):
        batch.MultiBatchScanner(tmotifs, device="cpu").collect_arrays()
    with pytest.raises(ValueError, match="no records bound"):
        batch.BatchReducer(tmotifs[0], device="cpu").max()
    with pytest.raises(ValueError, match="no sequences"):
        batch.BatchScanner(tmotifs[0], [], device="cpu")
