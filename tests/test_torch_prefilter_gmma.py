"""The host side of the prefilter's warpgroup kernel on the CPU: the
blocks it streams (``multi_kernel.gmma_blocks``) read back the way the
kernel multiplies them give the plain prefilter, phase C's planes stay
those of the packers, each lane tile's depth from ``chunk_m``, the order
of the blocks, the issued operations, the ``prefilter`` span's counts and
the two benchmark metrics that read them."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lightmotif_tpu_torch import convert
from lightmotif_tpu_torch.ops import multi, multi_kernel, torch_ops
from lightmotif_tpu_torch.scanner import MultiScanner
from lightmotif_tpu_torch.utils import profiling

from .torch_parity import random_motifs, sequences

ROOT = Path(__file__).resolve().parents[1]
LANES, KSTEP = multi_kernel.GMMA_LANES, multi_kernel.GMMA_KSTEP


def reread(seq, planes, chunk_m, t_eff, blocks) -> np.ndarray:
    """The warpgroup kernel's arithmetic in numpy, from its blocks alone
    (the planes give only their shape): for each block of the schedule, the
    one-hot windows' k-step times the block's lanes, the planes of a lane
    tile combined from the top byte down, less ``t_eff``, the max over
    every lane."""
    n_planes, chunks, lanes, rows, k = planes.shape
    sched = multi_kernel.gmma_schedule(chunk_m, n_planes, k)
    lp = seq.size
    ks_all = -(-rows * k // KSTEP)
    s = np.concatenate([np.minimum(seq, k - 1), np.full(ks_all * KSTEP // k + 2, k - 1)])
    onehot = np.eye(k, dtype=np.int64)[s].reshape(-1)
    windows = np.stack([onehot[p * k: p * k + ks_all * KSTEP] for p in range(lp)])
    halves = blocks.reshape(-1, LANES, 2, KSTEP // 2).copy()
    swapped = (np.arange(LANES) >> 2) & 1 == 1  # the 32-byte swizzle, undone
    halves[:, swapped] = halves[:, swapped, ::-1]
    cells = halves.reshape(-1, LANES, KSTEP).astype(np.int64)
    sums = {}
    for i, (tile, q, kk) in enumerate(sched):
        part = windows[:, kk * KSTEP:(kk + 1) * KSTEP] @ cells[i].T
        sums[tile, q] = sums.get((tile, q), 0) + part
    n_lanes = chunks * lanes
    tiles = -(-n_lanes // LANES)
    neg = np.full(tiles * LANES, -(1 << 40), np.int64)
    neg[:n_lanes] = -np.asarray(t_eff, np.int64)
    best = np.full(lp, np.iinfo(np.int64).min)
    for tile in range(tiles):
        total = sum(sums.get((tile, q), 0) * 256 ** q for q in range(n_planes))
        best = np.maximum(best, (total + neg[tile * LANES:(tile + 1) * LANES]).max(axis=1))
    return best


#: (lanes, motif rows, K, top cell): one to four byte planes, lanes in
#: partial tiles, shallow and deep shapes, protein K
SHAPES = [
    (16, 3, 5, 255),
    (300, 12, 5, 65535),
    (2048, 16, 5, 65535),
    (200, 48, 5, 65535),
    (64, 128, 5, 40000),
    (40, 30, 21, 65535),
    (48, 8, 2, (1 << 24) - 1),
    (32, 20, 21, 1 << 20),
]


@pytest.mark.parametrize("lanes,m,k,top", SHAPES,
                         ids=[f"{a}lanes-m{b}-k{c}" for a, b, c, _ in SHAPES])
def test_blocks_reread_give_the_plain_prefilter(lanes, m, k, top):
    rng = np.random.default_rng(lanes * 131 + m)
    m_pad = -(-lanes // 16) * 16
    cells = rng.integers(0, top + 1, size=(m_pad, m, k))
    cells[:, rng.random(m) < 0.2] = 0  # rows past some lanes' motifs
    seq = rng.integers(0, k + 1, size=600).astype(np.uint8)
    # thresholds that about a fifth of the window starts pass in some lane
    ranks = np.minimum(np.concatenate([seq, np.full(m, k - 1)]), k - 1)
    sums = sum(cells[:, j, ranks[j:j + seq.size]] for j in range(m))  # [lanes, starts]
    t = np.percentile(sums, 100 - 20 / m_pad, axis=1).astype(np.int64)
    planes, chunk_m, t_eff = multi._plane_table(cells, t)
    blocks = multi_kernel.gmma_blocks(planes, chunk_m)
    assert blocks.dtype == np.uint8 and blocks.shape[1:] == (LANES, KSTEP)
    assert blocks.shape[0] == len(multi_kernel.gmma_schedule(chunk_m, planes.shape[0], k))
    want = torch_ops.prefilter_any8(torch.from_numpy(seq), *(torch.from_numpy(a) for a in (
        planes, chunk_m, t_eff))).numpy()
    assert np.array_equal(reread(seq, planes, chunk_m, t_eff, blocks), want)
    assert (want >= 0).any() and (want < 0).any()  # not vacuous


def _group():
    rng = np.random.default_rng(7)
    motifs = random_motifs(rng, [5, 6, 8, 9, 12, 14, 15, 20, 25, 33] * 30)
    stack, lengths = multi.stack_motifs([p.data for p in motifs], 5)
    ths = np.asarray([p.score_distribution().score(1e-4) for p in motifs], np.float32)
    order = np.argsort(lengths, kind="stable")
    return multi.pack_motif_group(order, len(order), int(lengths.max()), stack, ths, 5)


def test_phase_c_planes_stay_the_packers_and_blocks_come_from_them():
    g = _group()
    d16, f16, off16 = multi.fine_discretize(g["pssm"])
    t16 = np.where(multi.unreachable_thresholds(g["pssm"], g["th"]), 65536,
                   multi.fine_thresholds(g["th"], f16, off16))
    k3, k5 = multi.pack_filters_k3(d16, t16), multi.pack_filters_k5(d16, t16)
    dev = multi.group_to_device(g, torch.device("cpu"))
    planes, chunk_m, t_c = dev["phase_c"]
    assert np.array_equal(planes.numpy(), k5[0]) and np.array_equal(planes.numpy(), k3[0])
    assert np.array_equal(chunk_m.numpy(), k5[1]) and np.array_equal(t_c.numpy(), k5[2])
    assert len(dev["k3"]) == 5 and dev["k3"][0] is planes  # one copy of the planes
    assert np.array_equal(dev["k3"][3].numpy(), multi_kernel.gmma_blocks(k3[0], k3[1]))
    assert dev["k3"][4] == tuple(multi_kernel.tile_ksteps(k3[1], 5).tolist())
    assert all(type(s) is int for s in dev["k3"][4])  # host ints: no read of the device


@pytest.mark.parametrize("mode", ["k5", "k4"])
def test_k4_k5_groups_share_their_planes_with_phase_c(mode):
    g = _group()
    if mode == "k5":
        dev = multi.group_from_filters(g["pssm"], g["th"], g["m_max"], 5, "cpu",
                                       filters_fine=(g["f_hi"], g["f_lo"]),
                                       widths=g["widths"])
    else:
        dms = np.clip(np.round(g["pssm"] * 4 + 40), 0, 255).astype(np.float32)
        filters_t = multi_kernel.pack_filters_any(dms, np.full(dms.shape[0], 200), 5)
        dev = multi.group_from_filters(g["pssm"], g["th"], g["m_max"], 5, "cpu",
                                       filters_t=filters_t)
    pre, phase_c = dev[mode], dev["phase_c"]
    assert len(pre) == 5 and pre[0] is phase_c[0] and pre[1] is phase_c[1]
    assert np.array_equal(pre[3].numpy(), multi_kernel.gmma_blocks(pre[0].numpy(),
                                                                  pre[1].numpy()))


@pytest.mark.parametrize("chunk_m,k,want", [
    ([16] * 8 + [20] * 8 + [3], 5, [3, 4, 1]),
    ([0] * 8, 5, [0]),
    ([1, 0, 0, 0, 0, 0, 0, 7], 21, [5]),
    ([32] * 9, 31, [31, 31]),
    ([6] * 4, 16, [3]),
], ids=["dna", "empty", "protein", "deepest", "whole-steps"])
def test_each_lane_tile_takes_its_deepest_chunks_ksteps(chunk_m, k, want):
    assert multi_kernel.tile_ksteps(np.asarray(chunk_m), k).tolist() == want


def test_schedule_walks_lane_tiles_planes_from_the_top_and_ksteps():
    k = 5
    rows = [12, 19, 56, 0, 44]  # lane tiles of 2, 3, 9, 0 and 7 k-steps
    chunk_m = np.repeat(rows, 8)
    ks = multi_kernel.tile_ksteps(chunk_m, k)
    assert ks.tolist() == [2, 3, 9, 0, 7]
    for n_planes in (1, 2, 3):
        sched = multi_kernel.gmma_schedule(chunk_m, n_planes, k)
        want = [(t, q, kk) for t in range(5) for q in range(n_planes - 1, -1, -1)
                for kk in range(int(ks[t]))]
        assert [tuple(r) for r in sched.tolist()] == want


@pytest.mark.parametrize("n_windows,rows,k,n_planes,pos", [
    (1, 16, 5, 2, 256), (256, 48, 5, 2, 256), (257, 48, 5, 1, 256), (257, 64, 5, 2, 128),
    (4_641_663, 16, 5, 2, 256), (1000, 16, 5, 3, 128), (1000, 32, 21, 2, 128)])
def test_issued_ops_count_whole_position_tiles_of_every_block(n_windows, rows, k, n_planes,
                                                                pos):
    # two halves a warpgroup (256 positions) while rows x K spans at most 8
    # k-steps and there are one or two planes
    planes = torch.zeros(n_planes, 2, 16, rows, k, dtype=torch.uint8)
    assert multi_kernel.gmma_tile_positions(planes.shape) == pos
    assert multi_kernel.gmma_deep(planes.shape) == (pos == 128)  # the loop of commit groups
    blocks = torch.zeros(96, LANES, KSTEP, dtype=torch.uint8)
    tiles = -(-n_windows // pos)
    assert multi_kernel.issued_ops(n_windows, planes, blocks) == 2 * tiles * pos * 96 * 4096


def test_wrappers_take_blocks_and_refuse_bad_ones():
    g = _group()
    dev = multi.group_to_device(g, torch.device("cpu"))
    seq = torch.from_numpy(np.random.default_rng(1).integers(0, 5, 4000).astype(np.uint8))
    multi_kernel.reset_launches()
    got = multi_kernel.prefilter_any8(seq, *dev["k3"])
    assert torch.equal(got, torch_ops.prefilter_any8(seq, *dev["k3"][:3]))
    assert set(multi_kernel.LAUNCHES.values()) == {0}  # the plain version on the CPU
    assert multi_kernel.issue_counts(seq, *dev["k3"]) == {"gmma": 0, "issued_ops": 0,
                                                          "deep_ops": 0}
    bad = dev["k3"][3][:, :, :16].contiguous()
    with pytest.raises(TypeError):
        multi_kernel.prefilter_any8(seq, *dev["k3"][:3], bad, dev["k3"][4])


@pytest.mark.parametrize("case", ["truncated", "extra", "ksteps-deeper", "ksteps-short",
                                  "ksteps-past-the-planes", "blocks-alone", "ksteps-alone"])
def test_blocks_that_miss_their_schedule_raise(case):
    # blocks stale or of another group would desynchronise the kernel's ring:
    # they are refused on the host, before a launch, on every device
    dev = multi.group_to_device(_group(), torch.device("cpu"))
    planes, chunk_m, t_eff, blocks, ksteps = dev["k3"]
    deepest = -(-planes.shape[3] * planes.shape[4] // KSTEP)
    bad = {"truncated": (blocks[:-1], ksteps),
           "extra": (torch.cat([blocks, blocks[:1]]), ksteps),
           "ksteps-deeper": (blocks, (*ksteps[:-1], ksteps[-1] + 1)),
           "ksteps-short": (blocks, ksteps[:-1]),
           "ksteps-past-the-planes": (blocks, (deepest + 1,) * len(ksteps)),
           "blocks-alone": (blocks, None),
           "ksteps-alone": (None, ksteps)}[case]
    seq = torch.zeros(500, dtype=torch.uint8)
    with pytest.raises(ValueError, match="blocks|ksteps"):
        multi_kernel.prefilter_any8(seq, planes, chunk_m, t_eff, *bad)


def test_the_shape_test_asks_the_library_once_a_shape(monkeypatch):
    from lightmotif_tpu_torch.ops import build

    asked = []
    fake = SimpleNamespace(lm_prefilter_gmma_takes=lambda *shape: asked.append(shape) or 1)
    monkeypatch.setattr(build, "library", lambda: fake)
    card = SimpleNamespace(type="cuda")
    multi_kernel._gmma_shape.cache_clear()
    try:
        for shape in [(2, 128, 16, 16, 5)] * 3 + [(1, 4, 16, 16, 5)]:
            assert multi_kernel.gmma_takes(SimpleNamespace(device=card, shape=shape))
    finally:
        multi_kernel._gmma_shape.cache_clear()
    assert asked == [(2, 128, 16, 5), (1, 4, 16, 5)]


def _profiled_scan(widths=(6, 9, 12, 20), protein=False):
    rng = np.random.default_rng(3)
    motifs = random_motifs(rng, list(widths), protein=protein)
    pssms, ths = convert.motif_set(motifs, [p.score_distribution().score(1e-3) for p in motifs])
    k = 21 if protein else 5
    seqs = [sequences(rng.integers(0, k - 1, size=12_000), protein=protein)[1]
            for _ in range(2)]
    ms = MultiScanner(pssms, thresholds=ths, device="cpu")
    ms.SEGMENT = 5000
    ms.scan_arrays(seqs[0])
    profiling.reset_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        ms.scan_arrays(seqs[1])
    return [r for r in profiling.spans() if r.name == "prefilter"]


def test_prefilter_spans_count_gmma_and_issued_ops():
    records = _profiled_scan()
    assert len(records) == 3  # three segments, one group
    for r in records:
        assert r.counts["gmma"] == 0 and r.counts["issued_ops"] == 0  # the CPU
        assert r.counts["windows"] > 0


def test_prefilter_spans_count_the_warpgroup_kernels_launches(monkeypatch):
    # as a card would: every launch through the warpgroup kernel
    monkeypatch.setattr(multi_kernel, "gmma_takes", lambda planes: True)
    records = _profiled_scan()
    assert records and all(r.counts["gmma"] == 1 for r in records)
    for r in records:
        assert r.counts["issued_ops"] > 0
        assert r.counts["issued_ops"] % (2 * 256 * 4096) == 0  # 256-position tiles
        assert r.counts["deep_ops"] == 0  # 20 rows of K = 5: 4 k-steps


def test_prefilter_spans_count_the_deep_shapes_operations(monkeypatch):
    # protein motifs of up to 20 rows: 14 k-steps a lane, the deep loop
    monkeypatch.setattr(multi_kernel, "gmma_takes", lambda planes: True)
    records = _profiled_scan(widths=(6, 13, 20), protein=True)
    assert records
    for r in records:
        assert r.counts["deep_ops"] == r.counts["issued_ops"] > 0
        assert r.counts["issued_ops"] % (2 * 128 * 4096) == 0  # 128-position tiles


def _reader(name):
    path = ROOT / "motifbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def _run(counts, kernels=("gmma_prefilter",)):
    """A synthetic traced run of two scans: each with two prefilter spans
    of ``counts`` and two device operations of 2 ms named ``kernels``
    (launched by the prefilter wrapper)."""
    caller = ["lightmotif_tpu_torch/ops/multi_kernel.py(415): prefilter_any8"]
    ops = [{"name": kernels[i % len(kernels)], "cat": "kernel", "ts": 0.0, "dur": 2000.0,
            "callers": caller} for i in range(4)]
    trace = SimpleNamespace(scan_bp=[100, 100], ops=ops, _host=[], _lo=0.0, _hi=1.0)
    trace.select = lambda k, c: ops  # noqa: E731
    trace.seconds = lambda sel: sum(o["dur"] for o in sel) / 1e6  # noqa: E731
    scans = []
    for scan in (1, 10):
        root = SimpleNamespace(name="scanner.scan", id=scan, parent=None, scan=scan,
                               start_ns=0, end_ns=1, counts={})
        pre = [SimpleNamespace(name="prefilter", id=scan + 1 + i, parent=scan, scan=scan,
                               start_ns=0, end_ns=1, counts=dict(c)) for i, c in enumerate(counts)]
        scans += [root, *pre]
    return SimpleNamespace(trace=trace), scans


@pytest.mark.parametrize("counts,share,tops", [
    ([{"gmma": 1, "issued_ops": 3 * 10**12}] * 2, 1.0, 1500.0),
    ([{"gmma": 1, "issued_ops": 2 * 10**12}, {"gmma": 0, "issued_ops": 0}], 0.5, 500.0),
    ([{"windows": 5}] * 2, None, None),
], ids=["all-gmma", "half", "a-program-without-the-counts"])
def test_gmma_metrics_read_the_spans_and_the_trace(monkeypatch, counts, share, tops):
    monkeypatch.syspath_prepend(str(ROOT))
    from motifbench import spans as mapping

    run, records = _run(counts)
    monkeypatch.setattr(mapping, "records", lambda: records)
    got_share = _reader("prefilter.gmma_share")(run)
    got_tops = _reader("prefilter.issued_tops")(run)
    assert got_share == (None if share is None else pytest.approx(share))
    # issued_ops over both scans over 4 x 2 ms of prefilter device time
    assert got_tops == (None if tops is None else pytest.approx(tops))


def test_gmma_metrics_give_none_without_a_trace(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    run = SimpleNamespace(trace=None)
    assert _reader("prefilter.gmma_share")(run) is None
    assert _reader("prefilter.issued_tops")(run) is None
