"""The port's database scan over many segments, on the CPU, at small
sizes: ``MultiScanner`` at several segment sizes on a genome with N runs
(whole segments of wildcards among them) against the JAX package's
``MultiScanner``; ``ShardedMultiScanner`` over 3 and 8 CPU shards of
several segments each against the single-device scan; the merge and sort
of the hit heads at positions up to 2**31 - 1 and database ids up to
4,691; the int32 guards on the capacities against the JAX guard.
"""

import numpy as np
import pytest
import torch

import lightmotif_tpu as jlm
from lightmotif_tpu.ops import multi as jmulti
from lightmotif_tpu.ops import multi_kernel as jmulti_kernel
from lightmotif_tpu.scanner import MultiScanner as JaxMultiScanner
import lightmotif_tpu_torch as tlm
from lightmotif_tpu_torch import convert
from lightmotif_tpu_torch.ops import multi, multi_kernel
from lightmotif_tpu_torch.parallel import ShardedMultiScanner, make_genome_mesh
from lightmotif_tpu_torch.parallel import mesh as tmesh
from lightmotif_tpu_torch.scanner import MultiScanner

from .torch_parity import bits, multi_triples, random_counts

LENGTH = 200_000
#: wildcard runs: at each end, and one that covers whole segments of every
#: size in SEGMENTS
N_RUNS = ((0, 700), (60_000, 135_000), (199_300, LENGTH))
SEGMENTS = (997, 4096, 65536)
#: a JASPAR2024-sized database on both strands: its largest index
DB_LAST_ID = 4691


@pytest.fixture(scope="module")
def database():
    """Eight seeded motifs of 5-20 columns and their reverse complements
    (the JAX package's matrices and the port's copies), thresholds at p =
    1e-3, the genome with its N runs, and the JAX scan's triples."""
    rng = np.random.default_rng(0x5CA1E)
    fwd = [jlm.CountMatrix(jlm.DNA, random_counts(rng, int(m), jlm.DNA.size))
           .to_freq(0.1).to_weight(None).to_scoring() for m in rng.integers(5, 21, 8)]
    motifs = fwd + [p.reverse_complement() for p in fwd]
    pssms, _ = convert.motif_set(motifs)
    ths = np.asarray([p.score_distribution().score(1e-3) for p in pssms], np.float32)
    genome = rng.integers(0, 4, size=LENGTH).astype(np.uint8)
    for lo, hi in N_RUNS:
        genome[lo:hi] = tlm.DNA.default_index
    want = multi_triples(JaxMultiScanner(motifs, jlm.EncodedSequence(genome), ths)
                         .collect_arrays())
    return pssms, ths, genome, want


def only_wildcards(genome, segment: int, m_max: int) -> int:
    """The segments of ``segment`` window starts whose windows (with the
    halo) read only wildcards."""
    wild = genome == tlm.DNA.default_index
    return sum(bool(wild[off : off + segment + m_max - 1].all())
               for off in range(0, LENGTH, segment))


@pytest.mark.parametrize("segment", SEGMENTS)
def test_many_segments_equal_jax(database, segment, monkeypatch):
    pssms, ths, genome, want = database
    assert only_wildcards(genome, segment, max(len(p) for p in pssms)) >= 1
    monkeypatch.setattr(MultiScanner, "SEGMENT", segment)
    seq = tlm.EncodedSequence(genome)
    ms = MultiScanner(pssms, seq, ths, device="cpu")
    assert multi_triples(ms.collect_arrays()) == want and len(want) > 100
    ms.host_reads = 0
    assert multi_triples(ms.collect_arrays()) == want
    assert ms.host_reads == 1  # the capacities settled: one read a scan


@pytest.mark.parametrize("shards", [3, 8])
def test_sharded_over_segments_equals_one_device(database, shards, monkeypatch):
    pssms, ths, genome, want = database
    monkeypatch.setattr(MultiScanner, "SEGMENT", 4096)
    sm = ShardedMultiScanner(pssms, thresholds=ths, mesh=make_genome_mesh(["cpu"] * shards))
    for _ in range(2):  # the first scan settles the capacities
        tmesh.reset_host_reads()
        got = sm.scan_arrays(genome)
        assert multi_triples(got) == want
        assert sm.shard_hits.sum() == len(want)
    assert tmesh.HOST_READS == 1
    assert all(dseq.length > 2 * 4096 for _, dseq in sm._bound.shards)


def test_sorted_heads_keep_the_order_and_values_at_the_largest_positions():
    """Six entries of two groups whose ids reach DB_LAST_ID, their chunks
    the last 3 * 2**20 positions below 2**31, one hit at 2**31 - 1: the
    heads merged and sorted on the device (and merged again from two
    parts, as two devices' are) give every kept hit in (motif, position)
    order with its exact f32 bits, and nothing of the slots past a
    count."""
    rng = np.random.default_rng(31)
    top, span = 2**31 - 1, 1 << 20
    groups = []
    for ids in (np.arange(0, DB_LAST_ID + 1, 2), np.arange(1, DB_LAST_ID + 1, 2)):
        groups.append({"ids": ids, "ids_dev": torch.as_tensor(ids)})
    entries, widths, want = [], [], []
    for gi, group in enumerate(groups):
        for j in range(3):
            offset = top + 1 - span * (j + 1)
            n_kept, cap_hits = int(rng.integers(50, 300)), 512
            pos = np.sort(rng.choice(span, n_kept, replace=False))
            if j == 0:
                pos[-1] = span - 1  # the position 2**31 - 1
            lanes = rng.integers(0, len(group["ids"]), n_kept)
            lanes[0] = len(group["ids"]) - 1  # the group's last id
            order = np.lexsort((lanes, pos))  # the core's (position, lane) order
            pos, lanes = pos[order], lanes[order]
            scores = rng.normal(0, 8, n_kept).astype(np.float32)
            packed = rng.integers(-2**31, 2**31, (3, cap_hits)).astype(np.int32)  # junk
            packed[0, :n_kept], packed[1, :n_kept] = pos, lanes
            packed[2, :n_kept] = scores.view(np.int32)
            counts = torch.tensor([n_kept + 7, n_kept + 3, n_kept, 1], dtype=torch.int32)
            entries.append(multi.Entry(counts, torch.as_tensor(packed), group, offset, gi,
                                       span, cap_hits, None))
            widths.append(cap_hits if j == 1 else n_kept)
            want += zip(group["ids"][lanes].tolist(), (offset + pos).tolist(),
                        bits(scores).tolist())
    want.sort()
    assert any(p == top for _, p, _ in want)
    assert max(i for i, _, _ in want) == DB_LAST_ID

    def kept(flat, n):
        counts, hits = multi.unpack_heads(flat.numpy(), n)
        total = int(counts[:, 2].sum())
        assert (hits[1, total:] == -1).all()
        return list(zip(hits[1, :total].tolist(), hits[0, :total].astype(np.int64).tolist(),
                        hits[2, :total].view(np.uint32).tolist()))

    flat = multi.sorted_heads(entries, widths, multi.heads_info(entries, widths))
    assert kept(flat, len(entries)) == want
    parts = [(entries[:2], widths[:2]), (entries[2:], widths[2:])]
    flats = [multi.sorted_heads(e, w, multi.heads_info(e, w)) for e, w in parts]
    assert kept(multi.merge_sorted_heads(flats, [2, len(entries) - 2]), len(entries)) == want
    # the whole fetch: int64 positions on the host
    mo, positions, scores = multi.collect_device(entries)
    assert positions.dtype == np.int64 and int(positions.max()) == top
    assert list(zip(mo.tolist(), positions.tolist(), bits(scores).tolist())) == want


def _refused_by_jax(cap: int, cap_hits: int, m_pad: int) -> None:
    """The JAX ``scan_multi_core`` refuses these capacities: its guard
    raises before any device work (the inputs are stand-ins)."""
    filters_t = np.zeros((jmulti_kernel.MAX_MK, m_pad), np.uint8)
    with pytest.raises(OverflowError):
        jmulti.scan_multi_core(np.zeros(8, np.uint8), None, filters_t,
                               np.zeros((1, 1, 5), np.float32), None, cap, 1, 5, False,
                               cap_hits)


@pytest.mark.parametrize("m_pad", [16, 2048])
def test_capacity_guards_refuse_where_jax_refuses(m_pad):
    n_words = m_pad // multi_kernel.BITS_PER_WORD
    edge = -(-2**31 // n_words)  # the least min(cap, cap_hits) refused
    edge_hits = 2**31 // multi_kernel.BITS_PER_WORD  # the least cap_hits refused
    assert multi_kernel.BITS_PER_WORD == jmulti_kernel.BITS_PER_WORD
    for cap, cap_hits in [(edge, edge), (edge, edge_hits), (edge_hits, edge_hits),
                          (1, edge_hits)]:
        _refused_by_jax(cap, cap_hits, m_pad)
        with pytest.raises(OverflowError):
            multi._check_capacities(cap, cap_hits, m_pad)
    for cap, cap_hits in [(edge - 1, edge_hits - 1), (edge_hits - 1, min(edge, edge_hits) - 1),
                          (2**40, min(edge, edge_hits) - 1)]:
        multi._check_capacities(cap, cap_hits, m_pad)


def test_the_seeds_and_the_segment_fit_the_guards():
    """A 2,048-lane group (the database's) fits the int32 guards at its
    seed capacities, and with every window start of a segment of
    ``MultiScanner.SEGMENT`` a candidate."""
    group = {"pssm": torch.zeros(2048, 1, 5), "phase_c": (None, None, torch.zeros(2048))}
    cap, cap_hits = multi.seed_capacities(group)
    assert (cap, cap_hits) == (multi.DEFAULT_CAPACITY, 2 * multi.DEFAULT_CAPACITY)
    multi._check_capacities(cap, cap_hits, multi.lanes(group))
    every = 1 << (MultiScanner.SEGMENT - 1).bit_length()  # a ratchet's power of two
    multi._check_capacities(every, cap_hits, multi.lanes(group))
    multi._check_capacities(every, every, multi.lanes(group))
