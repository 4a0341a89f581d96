"""The port's sharded scans (``lightmotif_tpu_torch.parallel``) on meshes
of 1, 3 and 8 CPU shards, against the port's single-device scans and the
JAX package's sharded scans on its 8 virtual CPU devices (positions and
f32 bits, last-max ties).  The JAX package runs as ``tests/test_parallel.py``
runs it."""

import numpy as np
import pytest
import torch

import lightmotif_tpu as jlm
import lightmotif_tpu_torch as tlm
from lightmotif_tpu import parallel as jpar
from lightmotif_tpu_torch import parallel as tpar
from lightmotif_tpu_torch.ops import kernels, multi
from lightmotif_tpu_torch.ops.pipeline import Pipeline
from lightmotif_tpu_torch.parallel import mesh as tmesh
from lightmotif_tpu_torch.scanner import MultiScanner, Scanner

from .data import PATTERNS
from .torch_parity import bits, cpu_choice, random_counts  # noqa: F401  (a fixture)

MESHES = [1, 3, 8]


def cpu_mesh(n: int) -> list:
    return tpar.make_genome_mesh(["cpu"] * n)


def mx000001():
    """MX000001 in both packages: (jax, torch)."""
    return tuple(lm.CountMatrix.from_sequences(lm.EncodedSequence.encode(p) for p in PATTERNS)
                 .to_freq(0.1).to_weight(None).to_scoring() for lm in (jlm, tlm))


def motifs(lm, rng, widths):
    k = lm.DNA.size
    return [lm.CountMatrix(lm.DNA, random_counts(rng, w, k)).to_freq(0.1)
            .to_weight(None).to_scoring() for w in widths]


def triples(hits) -> list:
    return [(h.motif, h.position, int(bits(h.score))) for h in hits]


def pairs(positions, scores) -> list:
    return list(zip(np.asarray(positions).tolist(), bits(scores).tolist()))


@pytest.fixture(scope="module")
def pssms():
    return mx000001()


@pytest.fixture(scope="module")
def genome():
    return np.random.default_rng(123).integers(0, 4, size=30_000).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_scan(pssms, genome):
    """The JAX package's sharded results on its 8 virtual CPU devices."""
    jp = pssms[0]
    seq = jlm.EncodedSequence(genome)
    sc = jpar.ShardedScanner(jp, seq, threshold=-8.0)
    hits = sc.collect()
    return {"hits": [(h.position, int(bits(h.score))) for h in hits],
            "max": sc.max(),
            "argmax": jpar.sharded_argmax(np.asarray(jp.data), genome.astype(np.int8))}


@pytest.mark.parametrize("args", [
    (100, 4, 15, 4, 32, None),
    (100, 4, 15, 4, 32, 32),
    (777, 3, 33, 4, 64, 64),
    (10, 8, 15, 4, 64, None),  # shorter than the motif: every shard empty
    (5000, 8, 7, 20, 1024, 1024),
])
def test_shard_sequence_equals_jax(args):
    n, n_shards, m, wildcard, pad, halo = args
    enc = (np.arange(n) % 4).astype(np.int8)
    got = tpar.shard_sequence(enc, n_shards, m, wildcard, pad_multiple=pad, halo=halo)
    want = jpar.shard_sequence(enc, n_shards, m, wildcard, pad_multiple=pad, halo=halo)
    assert got[0].dtype == want[0].dtype and np.array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_shard_sequence_halo_too_small():
    with pytest.raises(ValueError, match="halo"):
        tpar.shard_sequence(np.zeros(100, np.int8), 2, 15, 4, pad_multiple=32, halo=10)


def test_make_genome_mesh(cpu_choice, monkeypatch):  # noqa: F811
    assert tpar.make_genome_mesh() == [torch.device("cpu")]
    assert tpar.make_genome_mesh(["cpu"] * 8) == [torch.device("cpu")] * 8
    with pytest.raises(ValueError):
        tpar.make_genome_mesh([])


def test_make_genome_mesh_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tpar.make_genome_mesh()


@pytest.mark.parametrize("shards", MESHES)
def test_sharded_scan_equals_single_device(pssms, genome, jax_scan, shards):
    tp = pssms[1]
    seq = tlm.EncodedSequence(genome)
    single = [(h.position, int(bits(h.score))) for h in Scanner(tp, seq, -8.0, device="cpu")]
    sc = tpar.ShardedScanner(tp, seq, threshold=-8.0, mesh=cpu_mesh(shards), pad_unit=256)
    got = [(h.position, int(bits(h.score))) for h in sc.collect()]
    assert got == single == jax_scan["hits"] and got
    assert sc.shard_hits.shape == (shards,) and sc.shard_hits.sum() == len(got)
    dm = tp.to_discrete()
    positions, scores = tpar.sharded_scan(np.asarray(tp.data), np.asarray(dm.data), genome,
                                          -8.0, dm.scale(-8.0), mesh=cpu_mesh(shards))
    assert pairs(positions, scores) == single
    # max: the best exact score among the discrete candidates
    best = sc.max()
    want = Scanner(tp, seq, -8.0, device="cpu").max()
    assert (best.position, bits(best.score)) == (want.position, bits(want.score))
    jbest = jax_scan["max"]
    assert (best.position, bits(best.score)) == (jbest.position, bits(jbest.score))


@pytest.mark.parametrize("shards", MESHES)
def test_sharded_argmax_equals_score_max(pssms, genome, jax_scan, shards):
    tp = pssms[1]
    got = tpar.sharded_argmax(np.asarray(tp.data), genome, mesh=cpu_mesh(shards),
                              pad_unit=128)
    want = Pipeline("cpu").score_max(tp, tlm.EncodedSequence(genome))
    assert (bits(got[0]), got[1]) == (bits(want[0]), want[1])
    assert (bits(got[0]), got[1]) == (bits(jax_scan["argmax"][0]), jax_scan["argmax"][1])


@pytest.mark.parametrize("shards", [2, 3, 8])
def test_tie_across_shards_goes_to_the_last(pssms, shards):
    """The best word planted in the first and the last owned shard (and
    in the middle): equal f32 maxima, and the larger position wins."""
    tp = pssms[1]
    rng = np.random.default_rng(9)
    genome = rng.integers(0, 4, size=2000).astype(np.uint8)
    best_word = np.asarray(tp.data)[:, :4].argmax(axis=1).astype(np.uint8)
    chunk = tmesh._chunk_for(2000 - 14, shards, 64)
    spots = sorted({5, chunk + 3, (2000 - 14) - 20} if shards > 2 else {5, chunk + 3})
    for p in spots:
        genome[p:p + 15] = best_word
    owners = {p // chunk for p in spots}
    assert len(owners) == len(spots)  # every planted copy in its own shard
    mx, am = tpar.sharded_argmax(np.asarray(tp.data), genome, mesh=cpu_mesh(shards),
                                 pad_unit=64)
    assert am == spots[-1]
    assert bits(mx) == bits(tp.score_host(tlm.EncodedSequence(genome)).max())
    hit = tpar.ShardedScanner(tp, tlm.EncodedSequence(genome), threshold=10.0,
                              mesh=cpu_mesh(shards), pad_unit=64).max()
    assert hit.position == spots[-1]
    jmx, jam = jpar.sharded_argmax(np.asarray(mx000001()[0].data), genome.astype(np.int8),
                                   pad_unit=64)
    assert (bits(jmx), jam) == (bits(mx), am)


@pytest.mark.parametrize("length", [15, 40, 100, 130])
def test_genome_shorter_than_a_shard(pssms, length):
    """Shards past the genome are empty; the first owns every window."""
    tp = pssms[1]
    genome = np.random.default_rng(length).integers(0, 4, size=length).astype(np.uint8)
    seq = tlm.EncodedSequence(genome)
    mesh = cpu_mesh(8)
    low = float(tp.score_host(seq).min()) - 1.0  # keeps every window
    got = tpar.ShardedScanner(tp, seq, threshold=low, mesh=mesh, pad_unit=64)
    hits = got.collect()
    assert [(h.position, bits(h.score)) for h in hits] == [
        (h.position, bits(h.score)) for h in Scanner(tp, seq, low, device="cpu")]
    assert len(hits) == length - 14 and got.shard_hits[2:].sum() == 0
    mx, am = tpar.sharded_argmax(np.asarray(tp.data), genome, mesh=mesh, pad_unit=64)
    want = Pipeline("cpu").score_max(tp, seq)
    assert (bits(mx), am) == (bits(want[0]), want[1])


def test_genome_shorter_than_the_motif(pssms):
    tp = pssms[1]
    genome = np.zeros(10, np.uint8)
    assert tpar.sharded_argmax(np.asarray(tp.data), genome, mesh=cpu_mesh(3)) == (None, None)
    sc = tpar.ShardedScanner(tp, tlm.EncodedSequence(genome), -50.0, mesh=cpu_mesh(3))
    assert sc.collect() == [] and sc.max() is None


# -- the database scan ----------------------------------------------------------


@pytest.fixture(scope="module")
def database():
    """Fused motifs, one past the dense split and one unreachable
    threshold, in both packages, with a 20,000-symbol genome."""
    widths = [8, 14, 20, 6, 11]
    out = []
    for lm in (jlm, tlm):
        rng = np.random.default_rng(21)
        out.append(motifs(lm, rng, widths))
    genome = np.random.default_rng(22).integers(0, 4, size=20_000).astype(np.uint8)
    thresholds = [-6.0, -6.0, 1e9, -4.0, -5.0]
    return out[0], out[1], genome, thresholds


@pytest.mark.parametrize("shards", MESHES)
def test_sharded_multi_scan_equals_multiscanner(database, shards):
    jps, tps, genome, ths = database
    seq = tlm.EncodedSequence(genome)
    want = MultiScanner(tps, seq, ths, device="cpu").scan_arrays(seq)
    sm = tpar.ShardedMultiScanner(tps, thresholds=ths, mesh=cpu_mesh(shards))
    got = sm.scan_arrays(genome)
    assert all(np.array_equal(a, b) for a, b in zip(got, want)) and len(got[0])
    assert 2 not in got[0].tolist()  # the unreachable threshold
    assert sm.shard_hits.sum() == len(got[0])
    hits = tpar.sharded_multi_scan(tps, genome, ths, mesh=cpu_mesh(shards))
    assert triples(hits) == list(zip(*(a.tolist() for a in want[:2]),
                                     bits(want[2]).tolist()))


def test_sharded_multi_scan_equals_jax(database):
    jps, tps, genome, ths = database
    want = triples(jpar.sharded_multi_scan(jps, genome.astype(np.int8), ths))
    for shards in MESHES:
        assert triples(tpar.sharded_multi_scan(tps, genome, ths, mesh=cpu_mesh(shards))) == want


@pytest.mark.parametrize("shards", MESHES)
def test_sharded_multi_database_scale(monkeypatch, shards):
    """Groups of 2 motifs and a dense motif (DENSE_M_LIMIT lowered to 64)
    on the mesh equal MultiScanner."""
    monkeypatch.setattr(MultiScanner, "GROUP_MOTIFS", 2)
    monkeypatch.setattr(MultiScanner, "DENSE_M_LIMIT", 64)
    rng = np.random.default_rng(77)
    tps = motifs(tlm, rng, [16, 6, 11, 8, 14, 70])
    genome = rng.integers(0, 4, size=12_000).astype(np.uint8)
    seq = tlm.EncodedSequence(genome)
    long_scores = tps[-1].score_host(seq)
    ths = [-6.0] * 5 + [float(np.partition(long_scores, -40)[-40])]
    launches = []
    real = kernels.score_f32
    monkeypatch.setattr(tmesh.kernels, "score_f32",
                        lambda *a: launches.append(a[2]) or real(*a))
    sm = tpar.ShardedMultiScanner(tps, thresholds=ths, mesh=cpu_mesh(shards), pad_unit=1024)
    got = sm.scan_arrays(genome)
    dense_windows = sum(launches)
    want = MultiScanner(tps, seq, ths, device="cpu").scan_arrays(seq)
    (scanner,) = sm._scanners.values()
    assert len(scanner._groups) == 3 and scanner._route()["dense_idx"].tolist() == [5]
    # shards cut at chunk + m_max - 1: the longest motif's windows are
    # each scored once
    assert dense_windows == len(genome) - 70 + 1
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert set(got[0].tolist()) == set(range(6))


@pytest.mark.parametrize("shards", [1, 2, 8])
def test_dense_owns_its_true_window_count(monkeypatch, shards):
    """m = 33 buckets to 64 rows: ownership sized from the bucketed
    length would lose the last 31 window starts of a 127-symbol genome."""
    monkeypatch.setattr(MultiScanner, "DENSE_M_LIMIT", 16)
    rng = np.random.default_rng(5)
    (tp,) = motifs(tlm, rng, [33])
    genome = rng.integers(0, 4, size=127).astype(np.uint8)
    seq = tlm.EncodedSequence(genome)
    threshold = float(tp.score_host(seq).min()) - 1.0
    hits = tpar.sharded_multi_scan([tp], genome, [threshold], mesh=cpu_mesh(shards),
                                   pad_unit=64)
    assert len(hits) == 127 - 33 + 1
    want = MultiScanner([tp], seq, [threshold], device="cpu").collect()
    assert triples(hits) == triples(want)


def test_rebind_reuses_the_packed_database(monkeypatch):
    """One packed database per distinct device (8 shards on one device
    pack once), reused across binds; each genome's hits equal a fresh
    scan's."""
    monkeypatch.setattr(MultiScanner, "DENSE_M_LIMIT", 16)
    calls = []
    real = multi.database_groups
    monkeypatch.setattr(tmesh.multi, "database_groups",
                        lambda *a, **k: calls.append(a[5]) or real(*a, **k))
    rng = np.random.default_rng(21)
    tps = motifs(tlm, rng, [8, 10, 33])
    ths = [-5.0, -5.0, float(np.float32(-1e30))]
    mesh = cpu_mesh(8)
    sc = tpar.ShardedMultiScanner(tps, thresholds=ths, mesh=mesh, pad_unit=64)
    assert calls == [torch.device("cpu")]
    (scanner,) = sc._scanners.values()
    packed = [g["pssm"] for g in scanner._groups]
    for seed in (1, 2):
        genome = np.random.default_rng(seed).integers(0, 4, size=500).astype(np.uint8)
        seq = tlm.EncodedSequence(genome)
        before = len(calls)
        got = triples(sc.scan(genome))
        assert len(calls) == before  # no packing on a rebind
        assert got == triples(MultiScanner(tps, seq, ths, device="cpu").collect()) and got
        assert sum(1 for mo, _, _ in got if mo == 2) == 500 - 33 + 1
    after = [g["pssm"] for g in scanner._groups]
    assert packed and all(a is b for a, b in zip(packed, after))
    assert list(scanner._dense_dev) == [2]  # the dense motif uploaded once


def test_single_bucket_and_empty_sets(database):
    jps, tps, genome, ths = database
    sb = tpar.ShardedMultiScanner(tps, thresholds=ths, mesh=cpu_mesh(3), single_bucket=True)
    assert len({g["m_max"] for g in sb._scanners[torch.device("cpu")]._groups}) == 1
    seq = tlm.EncodedSequence(genome)
    assert triples(sb.scan(genome)) == triples(MultiScanner(tps, seq, ths,
                                                            device="cpu").collect())
    empty = tpar.ShardedMultiScanner(tps, thresholds=1e9, mesh=cpu_mesh(3))
    (scanner,) = empty._scanners.values()
    assert not scanner._groups and not scanner._route()["dense_idx"].size
    assert empty.scan(genome) == []
    assert tpar.sharded_multi_scan([], genome, []) == []
    with pytest.raises(ValueError, match="no sequence bound"):
        tpar.ShardedMultiScanner(tps, thresholds=ths, mesh=cpu_mesh(1)).collect()


def test_the_exchange_refuses_other_backends(monkeypatch):
    """Across processes the exchange runs over gloo alone: another
    backend is refused before any collective."""
    import torch.distributed as dist

    monkeypatch.setattr(tmesh, "_world", lambda: (0, 2))
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(RuntimeError, match="gloo"):
        tmesh._all_gather(np.zeros(2))
