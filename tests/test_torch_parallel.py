"""The port's sharded scans (``lightmotif_tpu_torch.parallel``) on meshes
of 1, 3 and 8 CPU shards, against the port's single-device scans and the
JAX package's sharded scans on its 8 virtual CPU devices (positions and
f32 bits, last-max ties).  The JAX package runs as ``tests/test_parallel.py``
runs it.  Also: the host reads per call whatever the number of shards,
the database scan's per-device workers, and the process exchange (a
one-rank gloo group, a stand-in NCCL)."""

import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

import lightmotif_tpu as jlm
import lightmotif_tpu_torch as tlm
from lightmotif_tpu import parallel as jpar
from lightmotif_tpu_torch import parallel as tpar
from lightmotif_tpu_torch.ops import kernels, multi
from lightmotif_tpu_torch.ops import multi_kernel
from lightmotif_tpu_torch.ops.pipeline import DeviceSequence, Pipeline
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


class StandInDist:
    """``torch.distributed`` with a process group of ``world`` ranks that
    all hold this rank's values."""

    def __init__(self, backend: str, world: int = 2):
        self.backend, self.world, self.gathered = backend, world, []

    def get_backend(self):
        return self.backend

    def get_world_size(self):
        return self.world

    def get_rank(self):
        return 0

    def all_gather(self, out, tensor):
        self.gathered.append(tensor)
        for o in out:
            o.copy_(tensor)


@pytest.mark.parametrize("backend", ["mpi", "ucc"])
def test_the_exchange_refuses_other_backends(monkeypatch, backend):
    """Across processes the exchange runs over gloo or NCCL alone: another
    backend is refused before any collective."""
    stand_in = StandInDist(backend)
    monkeypatch.setattr(tmesh, "_distributed", lambda: stand_in)
    with pytest.raises(RuntimeError, match="gloo or the nccl"):
        tmesh._all_gather(np.zeros(2))
    assert not stand_in.gathered


class CudaOnTheCpu(TorchFunctionMode):
    """Record the CUDA devices tensors are made on, and make them on the
    CPU (this build has no CUDA)."""

    def __init__(self):
        super().__init__()
        self.devices = []

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        device = kwargs.get("device")
        if device is not None and torch.device(device).type == "cuda":
            self.devices.append(torch.device(device))
            kwargs["device"] = "cpu"
        return func(*args, **kwargs)


def test_the_exchange_takes_nccl_on_the_current_device(monkeypatch):
    """Under NCCL the exchange's tensor is made on the current CUDA
    device, gathered, and read back."""
    stand_in = StandInDist("nccl", world=3)
    monkeypatch.setattr(tmesh, "_distributed", lambda: stand_in)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    tmesh.reset_host_reads()
    with CudaOnTheCpu() as mode:
        got = tmesh._all_gather(np.asarray([7, -1], np.int64))
    assert mode.devices == [torch.device("cuda", 3)]
    assert len(stand_in.gathered) == 1 and got.tolist() == [[7, -1]] * 3
    assert tmesh.HOST_READS == 1
    # the argmax merge over the stand-in: every rank holds this one's best
    with CudaOnTheCpu():
        assert tmesh._best_everywhere((np.float32(-2.5), 40)) == (-2.5, 40)
        assert tmesh._best_everywhere(None) is None


def test_one_rank_gloo_group_runs_the_exchange(pssms, genome, database, tmp_path,
                                               monkeypatch):
    """With a process group of one rank, every exchange runs the real
    all-gather (none is skipped), and the results are those of no group."""
    import torch.distributed as dist

    tp = pssms[1]
    seq = tlm.EncodedSequence(genome)
    mesh = cpu_mesh(3)
    _, tps, db_genome, ths = database
    alone = {"hits": tpar.ShardedScanner(tp, seq, -8.0, mesh=mesh).collect(),
             "max": tpar.ShardedScanner(tp, seq, -8.0, mesh=mesh).max(),
             "argmax": tpar.sharded_argmax(np.asarray(tp.data), genome, mesh=mesh),
             "db": tpar.ShardedMultiScanner(tps, thresholds=ths, mesh=mesh).scan_arrays(
                 db_genome)}
    calls = []
    real = dist.all_gather
    monkeypatch.setattr(dist, "all_gather", lambda *a, **k: calls.append(1) or real(*a, **k))
    dist.init_process_group("gloo", init_method=(tmp_path / "store").as_uri(),
                            world_size=1, rank=0)
    try:
        sc = tpar.ShardedScanner(tp, seq, -8.0, mesh=mesh)
        got, counted = {}, {}
        for name, fn in (
                ("prepare", sc._prep), ("hits", sc.collect), ("max", sc.max),
                ("argmax", lambda: tpar.sharded_argmax(np.asarray(tp.data), genome, mesh=mesh)),
                ("db", lambda: tpar.ShardedMultiScanner(tps, thresholds=ths, mesh=mesh)
                 .scan_arrays(db_genome))):
            before = len(calls)
            got[name] = fn()
            counted[name] = len(calls) - before
    finally:
        dist.destroy_process_group()
    # prepare: the shard block; collect: the shard block and the counts;
    # max: the best; argmax: the shard block and the best; the database:
    # the shard block (bind) and the counts (fetch)
    assert counted == {"prepare": 1, "hits": 2, "max": 1, "argmax": 2, "db": 2}
    assert got["hits"] == alone["hits"] and got["hits"]
    assert (got["max"].position, bits(got["max"].score)) == (alone["max"].position,
                                                             bits(alone["max"].score))
    assert got["argmax"] == alone["argmax"]
    assert all(np.array_equal(a, b) for a, b in zip(got["db"], alone["db"])) and len(got["db"][0])
    chunk = tmesh._chunk_for(len(genome) - 14, 3, 1024)
    assert sc.shard_hits.tolist() == [sum(h.position // chunk == d for h in got["hits"])
                                      for d in range(3)]


# -- the host reads and the workers ---------------------------------------------


@pytest.mark.parametrize("path", ["sharded_scan", "collect", "max", "argmax", "database"])
def test_host_reads_do_not_grow_with_shards(pssms, genome, database, path):
    """The reads of the device per call are the same on 1, 2 and 8
    shards of one device: every shard is issued before the host reads.
    The database scan, once its capacities have settled, reads each
    distinct device once."""
    tp = pssms[1]
    dm = tp.to_discrete()
    seq = tlm.EncodedSequence(genome)
    _, tps, db_genome, ths = database
    reads, heavy = [], []
    for shards in (1, 2, 8):
        mesh = cpu_mesh(shards)
        sc = tpar.ShardedScanner(tp, seq, threshold=-8.0, mesh=mesh, pad_unit=256)
        sc._prep()
        sm = tpar.ShardedMultiScanner(tps, thresholds=ths, mesh=mesh, pad_unit=256)
        call = {
            "sharded_scan": lambda: tpar.sharded_scan(
                np.asarray(tp.data), np.asarray(dm.data), genome, -8.0, dm.scale(-8.0),
                mesh=mesh, pad_unit=256),
            "collect": sc.collect,
            "max": sc.max,
            "argmax": lambda: tpar.sharded_argmax(np.asarray(tp.data), genome, mesh=mesh,
                                                  pad_unit=256),
            "database": lambda: sm.scan_arrays(db_genome),
        }[path]
        if path in ("collect", "database"):
            call()  # the first scan settles the capacities and the heads
        tmesh.reset_host_reads()
        got = call()
        reads.append(tmesh.HOST_READS)
        if path == "sharded_scan":
            # a one-shot call has no head hint: a shard that keeps more
            # hits than the first head is read once more
            chunk = tmesh._chunk_for(len(genome) - len(tp) + 1, shards, 256)
            heavy.append(int(np.bincount(got[0] // chunk).max()) > multi.HEAD_SLOTS)
    # every shard's counters with its hit head; the best; the database
    # scan's counters with its hit heads: once, on any number of shards
    assert reads == [1 + h for h in heavy] if path == "sharded_scan" else [1] * 3


@pytest.mark.parametrize("shards", MESHES)
def test_sharded_ratchet_from_a_capacity_of_one(database, shards, monkeypatch):
    """Every entry of every shard overflows at first and re-runs in its
    device's worker: the hits are MultiScanner's, and the next scan reads
    the device once."""
    monkeypatch.setattr(MultiScanner, "DENSE_M_LIMIT", 12)  # m = 14 goes dense
    _, tps, genome, ths = database
    seq = tlm.EncodedSequence(genome)
    want = MultiScanner(tps, seq, ths, device="cpu").scan_arrays(seq)
    sm = tpar.ShardedMultiScanner(tps, thresholds=ths, mesh=cpu_mesh(shards), cap=1,
                                  pad_unit=1024)
    (scanner,) = sm._scanners.values()
    assert scanner._route()["dense_idx"].tolist() == [1]
    tmesh.reset_host_reads()
    got = sm.scan_arrays(genome)
    assert all(np.array_equal(a, b) for a, b in zip(got, want)) and len(got[0])
    assert tmesh.HOST_READS > 1 and all(c > 1 for c, _ in scanner._group_state.values())
    assert sm.shard_hits.sum() == len(got[0])
    tmesh.reset_host_reads()
    again = sm.scan_arrays(genome)
    assert tmesh.HOST_READS == 1
    assert all(np.array_equal(a, b) for a, b in zip(again, want))


@pytest.mark.parametrize("pairs,want", [
    ([(5.0, 10), (5.0, 30), (4.0, 50)], (5.0, 30)),
    ([(-np.inf, 7), (-np.inf, 3)], (-np.inf, 7)),
    ([(1.0, 2)], (1.0, 2)),
    ([(2.0, 1 << 40), (2.0, (1 << 40) + 1), (1.5, 1 << 41)], (2.0, (1 << 40) + 1)),
])
def test_merge_best_keeps_the_last_max_rule(pairs, want):
    """The device merge: the larger score wins, the larger position among
    equal scores; positions stay int64 past 2**24 and 2**53 of a float."""
    tensors = [(torch.tensor(s, dtype=torch.float32), torch.tensor(p, dtype=torch.int64))
               for s, p in pairs]
    tmesh.reset_host_reads()
    assert tmesh._merge_best(tensors) == want
    assert tmesh.HOST_READS == 1
    assert tmesh._merge_best([]) is None


class TwoDeviceSequence(DeviceSequence):
    """A shard on the CPU that names its mesh entry (``cpu:0``/``cpu:1``)
    as its device, so a CPU mesh has two distinct devices: two workers."""

    def __init__(self, encoded, device):
        super().__init__(encoded, "cpu")
        self.mesh_device = torch.device(device)

    @property
    def device(self):
        return self.mesh_device


@pytest.fixture
def two_device_mesh(monkeypatch):
    monkeypatch.setattr(tmesh, "DeviceSequence", TwoDeviceSequence)
    return tpar.make_genome_mesh(["cpu:0", "cpu:1"] * 4)


def test_hits_do_not_depend_on_which_worker_ends_first(database, two_device_mesh,
                                                      monkeypatch):
    """At a capacity of one every entry overflows, so each device re-runs
    its entries in a worker of its own; the first device's worker is held
    back until the second's has ended: the hits are still MultiScanner's,
    in the same order."""
    jps, tps, genome, ths = database
    seq = tlm.EncodedSequence(genome)
    want = MultiScanner(tps, seq, ths, device="cpu").scan_arrays(seq)
    sm = tpar.ShardedMultiScanner(tps, thresholds=ths, mesh=two_device_mesh,
                                  cap=1).bind(genome)
    assert list(sm._scanners) == [torch.device("cpu", 0), torch.device("cpu", 1)]
    owners = [dseq.device.index for _, dseq in sm._bound.shards]
    assert owners == [0, 1] * (len(owners) // 2) + [0] * (len(owners) % 2)
    second_done, ended = threading.Event(), []
    real = tpar.ShardedMultiScanner._collect

    def collect(self, device, entries, first):
        if device.index == 0:
            assert second_done.wait(timeout=30)
        out = real(self, device, entries, first)
        ended.append(device.index)
        if device.index == 1:
            second_done.set()
        return out

    monkeypatch.setattr(tpar.ShardedMultiScanner, "_collect", collect)
    got = sm.collect_arrays()
    assert ended == [1, 0]  # the second device's worker ended first
    assert all(np.array_equal(a, b) for a, b in zip(got, want)) and len(got[0])
    assert sm.shard_hits.sum() == len(got[0])


def test_a_worker_exception_reaches_the_caller(database, two_device_mesh, monkeypatch):
    """An exception in one device's worker (its re-runs, at a capacity
    of one) is raised by the call, once every worker has ended."""
    jps, tps, genome, ths = database
    sm = tpar.ShardedMultiScanner(tps, thresholds=ths, mesh=two_device_mesh,
                                  cap=1).bind(genome)
    real, ended = tpar.ShardedMultiScanner._collect, []

    def collect(self, device, entries, first):
        if device.index == 1:
            raise RuntimeError("the second device failed")
        time.sleep(0.05)
        ended.append(device.index)
        return real(self, device, entries, first)

    monkeypatch.setattr(tpar.ShardedMultiScanner, "_collect", collect)
    with pytest.raises(RuntimeError, match="the second device failed"):
        sm.collect()
    assert ended == [0]  # the other worker ran to its end

    def fail(self, device, entries, first):
        raise RuntimeError("the only device failed")

    monkeypatch.setattr(tpar.ShardedMultiScanner, "_collect", fail)
    with pytest.raises(RuntimeError, match="the only device failed"):
        tpar.ShardedMultiScanner(tps, thresholds=ths, mesh=cpu_mesh(2), cap=1).scan(genome)


def test_launch_counts_are_exact_under_threads():
    """The kernel wrappers' launch counters add under a lock: many
    threads counting at once, with the interpreter switching threads
    every microsecond, lose no launch."""
    threads, per_thread = 16, 2000
    before = (kernels.LAUNCHES["score_u8"], multi_kernel.LAUNCHES["prefilter_any8"])

    def count():
        for _ in range(per_thread):
            kernels.count_launch(kernels.LAUNCHES, "score_u8")
            kernels.count_launch(multi_kernel.LAUNCHES, "prefilter_any8")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(target=count) for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(interval)
    assert kernels.LAUNCHES["score_u8"] - before[0] == threads * per_thread
    assert multi_kernel.LAUNCHES["prefilter_any8"] - before[1] == threads * per_thread


# -- the one-PSSM scan at fixed capacities ----------------------------------------


@pytest.mark.parametrize("shards", [1, 8])
@pytest.mark.parametrize("threshold", [12.0, -8.0])
def test_sharded_scan_at_a_capacity_of_four(pssms, genome, shards, threshold):
    """At ``cap=4`` the port's sharded scan equals the JAX package's: at
    12.0 no shard holds more than four candidates and both scan at 4; at
    -8.0 every shard overflows, and the JAX scan, which starts at its
    dense compaction, refuses (``OverflowError``) where the port runs each
    overflowed shard once more at the next power of two at or above the
    worst shard's count -- its hits are then the JAX scan's at its
    default capacity."""
    jp, tp = pssms
    jdm, dm = jp.to_discrete(), tp.to_discrete()
    t_scaled = dm.scale(threshold)
    kw = {"cap": 4} if threshold > 0 else {}
    if not kw:
        with pytest.raises(OverflowError):
            jpar.sharded_scan(np.asarray(jp.data), np.asarray(jdm.data), genome.astype(np.int8),
                              threshold, t_scaled, cap=4)
    want = pairs(*jpar.sharded_scan(np.asarray(jp.data), np.asarray(jdm.data),
                                    genome.astype(np.int8), threshold, t_scaled, **kw))
    got = tpar.sharded_scan(np.asarray(tp.data), np.asarray(dm.data), genome, threshold,
                            t_scaled, mesh=cpu_mesh(shards), cap=4)
    assert pairs(*got) == want and want
    sc = tpar.ShardedScanner(tp, tlm.EncodedSequence(genome), threshold=threshold,
                             mesh=cpu_mesh(shards))
    sc.cap = 4
    hits = sc.collect()
    assert pairs([h.position for h in hits], [h.score for h in hits]) == want
    best = sc.max()
    single = Scanner(tp, tlm.EncodedSequence(genome), threshold, device="cpu").max()
    assert (best.position, bits(best.score)) == (single.position, bits(single.score))


@pytest.mark.parametrize("shards", [1, 8])
def test_sharded_overflow_reruns_once_and_ratchets(pssms, genome, shards):
    """A ``ShardedScanner`` seeded at a capacity of four: every shard
    whose candidates outnumber it runs exactly once more, at the next
    power of two at or above the worst shard's count, which the scanner
    keeps; a steady call then reads once and runs nothing again."""
    tp = pssms[1]
    dm = tp.to_discrete()
    seq = tlm.EncodedSequence(genome)
    mesh = cpu_mesh(shards)
    sc = tpar.ShardedScanner(tp, seq, threshold=-8.0, mesh=mesh)
    sc.cap = 4
    prepared, _ = sc._prep()
    shards_, chunk, n_scores = prepared
    # each shard's candidate count, from the plain discrete scores
    counts = []
    for d, shard in shards_:
        n_local = tmesh._owned(n_scores, d, chunk)
        if n_local:
            u8 = kernels.score_u8(shard[: n_local + len(tp) - 1], torch.from_numpy(
                np.ascontiguousarray(dm.data, np.uint8)), n_local)
            counts.append(int((u8[:n_local] >= dm.scale(-8.0)).sum()))
    want = [(h.position, int(bits(h.score))) for h in Scanner(tp, seq, -8.0, device="cpu")]
    got = [(h.position, int(bits(h.score))) for h in sc.collect()]
    assert got == want
    assert sc.reruns == sum(c > 4 for c in counts) == len(counts)
    assert sc.cap == 1 << (max(counts) - 1).bit_length()
    tmesh.reset_host_reads()
    assert [(h.position, int(bits(h.score))) for h in sc.collect()] == want
    assert tmesh.HOST_READS == 1 and sc.reruns == len(counts)
    tmesh.reset_host_reads()
    best = sc.max()
    assert tmesh.HOST_READS == 1 and sc.reruns == len(counts)
    single = Scanner(tp, seq, -8.0, device="cpu").max()
    assert (best.position, bits(best.score)) == (single.position, bits(single.score))
