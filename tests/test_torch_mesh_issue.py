"""How the port's sharded database scan issues its work: one thread, the
steps group by group across the devices (as the JAX package launches
one program per group over its mesh), one read per distinct device, no
worker thread on the steady path; and the scanners' tokens and launch
counts around the CUDA graphs of a steady scan.  On the CPU, with a
mesh of four repeated CPU devices and a mixed mesh of two stand-in CPU
devices, against ``MultiScanner`` and the JAX package's
``ShardedMultiScanner`` on its 8 virtual CPU devices."""

import numpy as np
import pytest
import torch

import lightmotif_tpu as jlm
import lightmotif_tpu_torch as tlm
from lightmotif_tpu import parallel as jpar
from lightmotif_tpu_torch import parallel as tpar
from lightmotif_tpu_torch.ops import kernels, multi_kernel
from lightmotif_tpu_torch.ops.pipeline import DeviceSequence
from lightmotif_tpu_torch.parallel import mesh as tmesh
from lightmotif_tpu_torch.scanner import MultiScanner

from .torch_parity import bits, random_counts


class StandInSequence(DeviceSequence):
    """A shard on the CPU that names its mesh entry (``cpu:0``/``cpu:1``)
    as its device, so a CPU mesh has two distinct devices."""

    __slots__ = ("mesh_device",)

    def __init__(self, encoded, device):
        super().__init__(encoded, "cpu")
        self.mesh_device = torch.device(device)

    @property
    def device(self):
        return self.mesh_device


MIXED = ["cpu:0", "cpu:1", "cpu:1", "cpu:0", "cpu:1"]


def mesh_of(name: str, monkeypatch) -> list:
    if name == "four cpu":
        return tpar.make_genome_mesh(["cpu"] * 4)
    monkeypatch.setattr(tmesh, "DeviceSequence", StandInSequence)
    return tpar.make_genome_mesh(MIXED)


@pytest.fixture(scope="module")
def database():
    """Motifs of 6-20 columns in both packages (one past the dense split
    where a test lowers it, one unreachable threshold), an 8,000-symbol
    genome and a second one of 3,000."""
    widths = [8, 14, 20, 6, 11, 9]
    out = []
    for lm in (jlm, tlm):
        rng = np.random.default_rng(41)
        out.append([lm.CountMatrix(lm.DNA, random_counts(rng, w, lm.DNA.size)).to_freq(0.1)
                    .to_weight(None).to_scoring() for w in widths])
    rng = np.random.default_rng(42)
    genomes = [rng.integers(0, 4, size=n).astype(np.uint8) for n in (8_000, 3_000)]
    thresholds = [-6.0, -6.0, 1e9, -4.0, -5.0, -5.5]
    return out[0], out[1], genomes, thresholds


def triples(arrays) -> list:
    return list(zip(arrays[0].tolist(), arrays[1].tolist(), bits(arrays[2]).tolist()))


@pytest.mark.parametrize("mesh", ["four cpu", "mixed"])
def test_meshes_equal_multiscanner_and_jax(database, mesh, monkeypatch):
    jps, tps, genomes, ths = database
    devices = mesh_of(mesh, monkeypatch)
    sm = tpar.ShardedMultiScanner(tps, thresholds=ths, mesh=devices, pad_unit=1024)
    for genome in genomes:
        seq = tlm.EncodedSequence(genome)
        want = MultiScanner(tps, seq, ths, device="cpu").scan_arrays(seq)
        jax_hits = jpar.sharded_multi_scan(jps, genome.astype(np.int8), ths)
        for _ in range(2):  # the first scan settles the capacities
            got = sm.scan_arrays(genome)
            assert all(np.array_equal(a, b) for a, b in zip(got, want)) and len(got[0])
            assert triples(got) == [(h.motif, h.position, int(bits(h.score)))
                                    for h in jax_hits]
            assert sm.shard_hits.sum() == len(got[0])


@pytest.mark.parametrize("mesh", ["four cpu", "mixed"])
@pytest.mark.parametrize("dense", [False, True])
def test_every_device_queues_a_group_before_any_device_the_next(database, mesh, dense,
                                                                 monkeypatch):
    """The issue log: each step as it is queued, with its device and
    shard.  Every shard's step of group g (segment s) comes before any
    shard's step of the next; the dense motifs come last; the shards of
    each step go in mesh order."""
    jps, tps, genomes, ths = database
    if dense:
        monkeypatch.setattr(MultiScanner, "DENSE_M_LIMIT", 12)  # m = 14 and 20 go dense
    monkeypatch.setattr(MultiScanner, "GROUP_MOTIFS", 2)
    monkeypatch.setattr(MultiScanner, "SEGMENT", 1024)
    devices = mesh_of(mesh, monkeypatch)
    sm = tpar.ShardedMultiScanner(tps, thresholds=ths, mesh=devices, pad_unit=1024)
    sm.bind(genomes[0])
    log, real = [], tpar.ShardedMultiScanner._queue

    def queue(self, d, scanner, step):
        log.append((step[0], d, scanner.device))
        return real(self, d, scanner, step)

    monkeypatch.setattr(tpar.ShardedMultiScanner, "_queue", queue)
    sm.collect_arrays()
    orders = [order for order, _, _ in log]
    assert orders == sorted(orders)  # group by group, segment by segment
    n_groups = len(next(iter(sm._scanners.values()))._groups)
    assert n_groups >= 2 and len(set(orders)) > n_groups
    for order in set(orders):
        rows = [(shard, device) for o, shard, device in log if o == order]
        shards = [shard for shard, _ in rows]
        assert shards == sorted(shards)
    by_shard = {d: dseq.device for d, dseq in sm._bound.shards}
    assert all(by_shard[shard] == device for _, shard, device in log)
    assert len({device for _, _, device in log}) == len(set(devices))
    dense_orders = [o for o in orders if o[0] >= n_groups]
    assert bool(dense_orders) == dense
    assert orders[len(orders) - len(dense_orders):] == dense_orders


@pytest.mark.parametrize("mesh", ["four cpu", "mixed"])
def test_one_read_per_steady_call_and_no_worker(database, mesh, monkeypatch):
    """A steady scan reads once, whatever the number of distinct devices
    (several devices' heads are merged on the first), and starts no
    thread: the workers are for re-runs only."""
    jps, tps, genomes, ths = database
    sm = tpar.ShardedMultiScanner(tps, thresholds=ths, mesh=mesh_of(mesh, monkeypatch),
                                  pad_unit=1024).bind(genomes[0])
    want = sm.collect_arrays()  # settles the capacities and the heads

    class NoThreads:
        def __init__(self, *args, **kwargs):
            raise AssertionError("a worker thread on the steady path")

    monkeypatch.setattr(tmesh.concurrent.futures, "ThreadPoolExecutor", NoThreads)
    for _ in range(2):
        tmesh.reset_host_reads()
        got = sm.collect_arrays()
        assert tmesh.HOST_READS == 1
        assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_a_second_genome_bound_before_the_first_is_fetched(database):
    """MultiScanner: dispatch one genome, bind and dispatch another, then
    fetch both tokens, in either order; and the same genome dispatched
    twice before either token is fetched."""
    jps, tps, genomes, ths = database
    seqs = [tlm.EncodedSequence(g) for g in genomes]
    want = [MultiScanner(tps, s, ths, device="cpu").scan_arrays(s) for s in seqs]
    ms = MultiScanner(tps, thresholds=ths, device="cpu")
    for first, second in ((0, 1), (1, 0), (0, 0)):
        token_a = ms.bind(seqs[first]).dispatch()
        token_b = ms.bind(seqs[second]).dispatch()
        for token, i in ((token_b, second), (token_a, first)):
            got = ms.fetch(token)
            assert all(np.array_equal(a, b) for a, b in zip(got, want[i])) and len(got[0])


def test_a_recorded_graph_counts_its_launches_at_each_replay():
    """A wrapper called while a graph is recorded launches nothing: its
    count goes to the recording's tally, and each replay adds the tally;
    outside a recording the count goes straight to the wrapper's."""
    before = dict(multi_kernel.LAUNCHES)
    tally = []
    with kernels.recording(tally):
        kernels.count_launch(multi_kernel.LAUNCHES, "prefilter_any8")
        kernels.count_launch(multi_kernel.LAUNCHES, "prefilter_any16", 2)
    assert multi_kernel.LAUNCHES == before
    assert tally == [(multi_kernel.LAUNCHES, "prefilter_any8", 1),
                     (multi_kernel.LAUNCHES, "prefilter_any16", 2)]
    for _ in range(3):
        kernels.count_replay(tally)
    assert multi_kernel.LAUNCHES["prefilter_any8"] == before["prefilter_any8"] + 3
    assert multi_kernel.LAUNCHES["prefilter_any16"] == before["prefilter_any16"] + 6
    kernels.count_launch(multi_kernel.LAUNCHES, "prefilter_any8")
    assert multi_kernel.LAUNCHES["prefilter_any8"] == before["prefilter_any8"] + 4


def test_graphs_are_kept_at_one_key_per_owner_and_tag():
    """The bookkeeping of :class:`~.ops.graphs.Replays` (no capture: the
    CPU runs no graph): the first issue of a name at a key is recorded,
    the next is one to replay; a new key of the same owner and tag drops
    the last key's work and memos (and a graph dropped so is not held
    again when its key comes back), another tag or owner keeps its own,
    and an owner's work goes with it."""
    import gc

    from lightmotif_tpu_torch.ops import graphs

    class Owner:
        pass

    replays, a, b = graphs.Replays("cpu"), Owner(), Owner()
    assert not replays.seen(a, "t", 1, "steps")
    assert replays.seen(a, "t", 1, "steps")
    out = ["outputs"]  # a graph of key 1 (none is captured on the CPU)
    replays._work(a, "t", 1)["steps"] = graphs._Graph(None, out, [])
    assert replays.holds(a, "t", 1, "steps", out)
    assert not replays.holds(a, "t", 1, "steps", ["other outputs"])
    assert replays.memo(a, "t", 1, "info", lambda: [1]) == [1]
    assert replays.memo(a, "t", 1, "info", lambda: [2]) == [1]  # kept
    assert not replays.seen(a, "u", 1, "steps") and not replays.seen(b, "t", 1, "steps")
    assert not replays.seen(a, "t", 2, "steps")  # a new key: the last one's work dropped
    assert not replays.holds(a, "t", 1, "steps", out)
    assert replays.memo(a, "t", 2, "info", lambda: [3]) == [3]
    assert not replays.seen(a, "t", 1, "steps")  # back to key 1: from the start
    assert not replays.holds(a, "t", 1, "steps", out)
    assert replays.seen(a, "u", 1, "steps") and replays.seen(b, "t", 1, "steps")
    del b
    gc.collect()
    assert len(replays._sets) == 1
    assert replays.captured == replays.replayed == 0
