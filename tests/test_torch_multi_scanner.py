"""The port's ``MultiScanner`` on the CPU against the JAX package's.

Both packages scan the same motif database (carried across with
``lightmotif_tpu_torch.convert.motif_set``) and the same sequence, and
must return the same (motif, position, f32 bits) triples in the same
(motif, position) order -- against the JAX windows path, which the JAX
package runs on the CPU, and against its fused Pallas path in interpret
mode.  The port's hits must also be those of its own per-motif
``Scanner``.
"""

import os
import pathlib
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import lightmotif_tpu as jlm
import lightmotif_tpu_torch as tlm
from lightmotif_tpu.ops import kernels as jax_kernels
from lightmotif_tpu.scanner import MultiScanner as JaxMultiScanner
from lightmotif_tpu_torch import convert
from lightmotif_tpu_torch.scanner import MultiHit, MultiScanner

from .test_multi import make_motifs
from .torch_parity import bits, multi_triples, sequences

THRESHOLDS = [-10.0, -3.0, -5.0]


@pytest.fixture(scope="module")
def genome():
    rng = np.random.default_rng(99)
    return sequences(rng.integers(0, 4, size=50_000))


def _both(motifs, thresholds, jseq, tseq, **port_kw):
    """(port triples, JAX triples) of one database scan."""
    pssms, ths = convert.motif_set(motifs, thresholds)
    got = MultiScanner(pssms, tseq, ths, device="cpu", **port_kw).collect_arrays()
    want = JaxMultiScanner(motifs, jseq, thresholds).collect_arrays()
    return multi_triples(got), multi_triples(want)


def test_matches_jax_and_the_single_scanner(genome):
    jseq, tseq = genome
    motifs = make_motifs()
    thresholds = [-12.0, -4.0, -6.0]
    got, want = _both(motifs, thresholds, jseq, tseq)
    assert got == want and got
    pssms, _ = convert.motif_set(motifs)
    single = sorted(
        (i, h.position, int(bits(h.score)))
        for i, (p, t) in enumerate(zip(pssms, thresholds))
        for h in tlm.Scanner(p, tseq, threshold=t, device="cpu"))
    assert got == single


def test_fused_interpret_path_matches(genome, monkeypatch):
    # the JAX fused path (Pallas K3 in interpret mode), grouped
    jseq, tseq = genome
    motifs = make_motifs() + [p.reverse_complement() for p in make_motifs()]
    thresholds = THRESHOLDS * 2
    jax_kernels.INTERPRET = True
    jax.clear_caches()
    try:
        monkeypatch.setattr(JaxMultiScanner, "GROUP_MOTIFS", 4)
        want = multi_triples(JaxMultiScanner(motifs, jseq, thresholds).collect_arrays())
    finally:
        jax_kernels.INTERPRET = False
        jax.clear_caches()
    monkeypatch.setattr(MultiScanner, "GROUP_MOTIFS", 4)
    pssms, ths = convert.motif_set(make_motifs(), THRESHOLDS, both_strands=True)
    ms = MultiScanner(pssms, tseq, ths, device="cpu")
    assert multi_triples(ms.collect_arrays()) == want and want
    assert len(ms._groups) == 2


def test_scalar_threshold_and_collect_forms(genome):
    jseq, tseq = genome
    got, want = _both(make_motifs(), -8.0, jseq, tseq)
    assert got == want
    pssms, _ = convert.motif_set(make_motifs())
    ms = MultiScanner(pssms, tseq, -8.0, capacity=8, device="cpu")
    hits = ms.collect()
    assert all(isinstance(h, MultiHit) for h in hits)
    assert [(h.motif, h.position, int(bits(h.score))) for h in hits] == got
    assert all(h.score >= -8.0 for h in hits)


def test_empty_sequence():
    motifs = make_motifs()  # every motif is longer than 4
    jseq, tseq = sequences(jlm.EncodedSequence.encode("ACGT").data)
    got, want = _both(motifs, -5.0, jseq, tseq)
    assert got == want == []
    pssms, _ = convert.motif_set(motifs)
    assert MultiScanner(pssms, tseq, -5.0, device="cpu").collect() == []


def test_bind_checks_the_alphabet_and_needs_a_sequence():
    pssms, _ = convert.motif_set(make_motifs())
    ms = MultiScanner(pssms, thresholds=-8.0, device="cpu")
    with pytest.raises(ValueError, match="no sequence bound"):
        ms.collect()
    with pytest.raises(ValueError, match="alphabet"):
        ms.bind(tlm.EncodedSequence.encode("MKVLATTR", tlm.PROTEIN))


def test_rebind_and_same_object(genome):
    jseq, tseq = genome
    motifs = make_motifs()
    pssms, ths = convert.motif_set(motifs, THRESHOLDS)
    rng = np.random.default_rng(31)
    other_j, other_t = sequences(rng.integers(0, 4, size=30_000))
    ms = MultiScanner(pssms, thresholds=ths, device="cpu")
    for js, ts in ((jseq, tseq), (other_j, other_t), (jseq, tseq)):
        got = multi_triples(ms.scan_arrays(ts))
        want = multi_triples(JaxMultiScanner(motifs, js, THRESHOLDS).collect_arrays())
        assert got == want and got
    first = ms.bind(tseq)._dseq
    assert ms.bind(tseq)._dseq is first  # the same object: no new upload
    copy = tlm.EncodedSequence(np.asarray(tseq.data).copy())
    assert ms.bind(copy)._dseq is not first


def test_dispatch_fetch_after_rebind(genome):
    jseq, tseq = genome
    motifs = make_motifs()
    pssms, ths = convert.motif_set(motifs, [-12.0, -4.0, -6.0])
    rng = np.random.default_rng(7)
    j2, t2 = sequences(rng.integers(0, 4, size=30_000))
    ms = MultiScanner(pssms, tseq, ths, device="cpu")
    tok1 = ms.dispatch()
    ms.bind(t2)
    tok2 = ms.dispatch()
    got2 = multi_triples(ms.fetch(tok2))  # out of order on purpose
    got1 = multi_triples(ms.fetch(tok1))
    for got, js in ((got1, jseq), (got2, j2)):
        want = JaxMultiScanner(motifs, js, [-12.0, -4.0, -6.0]).collect_arrays()
        assert got == multi_triples(want) and got


@pytest.mark.parametrize("segment", [None, 7_000])
def test_ratchet_from_a_capacity_of_one_keeps_the_hits(genome, monkeypatch, segment):
    # every group and dense motif overflows at first and re-runs at doubled
    # capacities until it fits: the hits are the JAX package's all the way,
    # and once the ratchets have settled a scan reads the device once
    jseq, tseq = genome
    motifs = make_motifs() + [p.reverse_complement() for p in make_motifs()]
    thresholds = THRESHOLDS * 2
    want = multi_triples(JaxMultiScanner(motifs, jseq, thresholds).collect_arrays())
    monkeypatch.setattr(MultiScanner, "GROUP_MOTIFS", 2)
    monkeypatch.setattr(MultiScanner, "DENSE_M_LIMIT", 12)  # the two m = 15 motifs
    pssms, ths = convert.motif_set(motifs, thresholds)
    ms = MultiScanner(pssms, tseq, ths, capacity=1, device="cpu")
    if segment:
        ms.SEGMENT = segment
    assert multi_triples(ms.scan_arrays(tseq)) == want and want
    assert len(ms._groups) == 2 and ms._route()["dense_idx"].tolist() == [0, 3]
    assert set(ms._group_state) == {0, 1, ("dense", 0), ("dense", 3)}
    assert all(cap > 1 for cap, _ in ms._group_state.values())
    first = ms.host_reads
    assert first > 1  # the re-runs read again
    ms.host_reads = 0
    for _ in range(2):
        assert multi_triples(ms.scan_arrays(tseq)) == want
    assert ms.host_reads == 2  # one read per collect_arrays


def test_steady_scan_reads_the_device_once_per_collect(genome):
    jseq, tseq = genome
    pssms, ths = convert.motif_set(make_motifs(), [-12.0, -4.0, -6.0])
    ms = MultiScanner(pssms, tseq, ths, device="cpu")
    ms.collect_arrays()
    for n in range(1, 4):
        ms.host_reads = 0
        hits = ms.collect_arrays()
        assert ms.host_reads == 1 and len(hits[0])
    # a token's entries hold the counters and hits on the device
    token = ms.dispatch()
    assert token["entries"] and all(e.counts.dtype == torch.int32 for e in token["entries"])
    assert ms.host_reads == 1  # dispatch reads nothing


def test_cpu_scan_leaves_jax_out(tmp_path):
    root = pathlib.Path(__file__).resolve().parents[1]
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import lightmotif_tpu_torch as lm\n"
        "from lightmotif_tpu_torch.scanner import MultiScanner\n"
        "cm = lm.CountMatrix.from_sequences(lm.EncodedSequence.encode(p)\n"
        "    for p in ['GTTGACCTTATCAAC', 'GTTGATCCAGTCAAC'])\n"
        "pssm = cm.to_freq(0.1).to_weight(None).to_scoring()\n"
        "seq = lm.EncodedSequence(np.random.default_rng(0).integers(0, 4, 20000).astype(np.uint8))\n"
        "mo, pos, sc = MultiScanner([pssm, pssm.reverse_complement()], seq, 5.0,\n"
        "                           device='cpu').scan_arrays(seq)\n"
        "assert len(mo) > 0\n"
        "bad = sorted(m for m in sys.modules\n"
        "             if m.split('.')[0] in ('jax', 'jaxlib', 'lightmotif_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
        text=True, env=dict(os.environ, PYTHONPATH=str(root)), timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
