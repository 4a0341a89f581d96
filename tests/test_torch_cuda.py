"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip.  The
file imports neither JAX nor the JAX package, so it runs where only the
port is installed::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import ctypes
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from lightmotif_tpu_torch import DNA, PROTEIN, CountMatrix, EncodedSequence, batch
from lightmotif_tpu_torch.ops import kernels, multi, multi_kernel, multi_stages, torch_ops
from lightmotif_tpu_torch.probes import prefilter as probes
from lightmotif_tpu_torch.probes import scoring
from lightmotif_tpu_torch.scanner import MultiScanner

from .torch_segments import CASES as SEGMENT_CASES
from .torch_segments import best_of_hits, segment_inputs

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


def _card_args(packed, device) -> list:
    """Host prefilter filters ``(planes, chunk_m, t_eff)`` on the card with
    their blocks for the warpgroup kernel and the blocks' k-steps, as a
    device group holds them."""
    planes, chunk_m, _ = packed
    ksteps = tuple(multi_kernel.tile_ksteps(chunk_m, planes.shape[-1]).tolist())
    return [*(torch.from_numpy(a).to(device)
              for a in (*packed, multi_kernel.gmma_blocks(planes, chunk_m))), ksteps]


def _mma_kernel(name, seq, args):
    """The earlier design, mma_kernel's production instantiation, on the
    planes of ``args``."""
    from lightmotif_tpu_torch.ops import build

    return multi_kernel.launch(name, build.library().lm_prefilter_production(), seq,
                               *args[:3], lib=build.probe_library())


def _motifs(rng, widths, alphabet):
    k = len(alphabet.symbols)
    out = []
    for w in widths:
        counts = rng.integers(0, 12, size=(w, k))
        counts[:, k - 1] = 0
        counts[:, 0] += 1
        out.append(CountMatrix(alphabet, counts).to_freq(0.1).to_weight(None).to_scoring())
    return out


@pytest.mark.parametrize("alphabet,widths", [(DNA, [2, 5, 17, 33, 128]),
                                             (PROTEIN, [5, 21, 32])],
                         ids=["dna", "protein"])
def test_prefilter_any8_kernel_matches_plain(cuda, alphabet, widths):
    rng = np.random.default_rng(len(widths))
    motifs = _motifs(rng, widths, alphabet)
    k = len(alphabet.symbols)
    stack, lengths = multi.stack_motifs([p.data for p in motifs], k)
    m_max = int(lengths.max())
    ths = np.full(len(widths), -5.0, np.float32)
    ths[0] = 1e6  # a never-pass lane
    g = multi.pack_motif_group(np.arange(len(widths)), len(widths), m_max,
                               stack, ths, k)
    seq = rng.integers(0, k, size=100_000).astype(np.uint8)
    seq_dev = torch.from_numpy(seq).to(cuda)
    args = _card_args(g["k3"], cuda)
    before = dict(multi_kernel.LAUNCHES)
    got = multi_kernel.prefilter_any8(seq_dev, *args)
    want = torch_ops.prefilter_any8(seq_dev, *args)
    torch.cuda.synchronize()
    assert multi_kernel.LAUNCHES["prefilter_any8"] == before["prefilter_any8"] + 1
    assert multi_kernel.LAUNCHES["prefilter_gmma"] == before["prefilter_gmma"] + 1
    n = seq.size - m_max + 1
    assert torch.equal(got[:n], want[:n])
    assert torch.equal(got, _mma_kernel("prefilter_any8", seq_dev, args))


def test_multiscanner_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(7)
    motifs = _motifs(rng, [6, 10, 15, 15, 22, 40, 150], DNA)
    ths = [p.score_distribution().score(1e-4) for p in motifs]
    seq = EncodedSequence(rng.integers(0, 4, size=200_000).astype(np.uint8))
    multi_kernel.reset_launches()
    got = MultiScanner(motifs, seq, ths, device=cuda).scan_arrays(seq)
    assert multi_kernel.LAUNCHES["prefilter_any8"] >= 1
    want = MultiScanner(motifs, seq, ths, device="cpu").scan_arrays(seq)
    assert len(want[0]) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("precision", ["highest", "high", "medium"])
def test_phase_c_is_exact_on_the_card_at_every_matmul_precision(cuda, precision):
    # cells up to 65535 (full hi and lo bytes, two planes) and the longest
    # fused rows; "high" lets a matmul run in TF32 (11 significant bits),
    # "medium" in bf16 (8): phase C sums the planes' integer cells, so each
    # precision gives the exact integers
    rng = np.random.default_rng(17)
    m, k, count = 128, 5, 37
    stack = rng.normal(scale=4.0, size=(count, m, k)).astype(np.float32)
    stack[:, :, k - 1] = stack[:, :, : k - 1].max(axis=2) + 1e6  # clips to 65535
    g = multi.pack_motif_group(np.arange(count), count, m, stack,
                               np.full(count, -1e3, np.float32), k)
    d16 = multi.fine_discretize(g["pssm"])[0].astype(np.int64)
    assert d16.max() == 65535 and (d16 & 255).max() == 255
    seq = rng.integers(0, k, size=20_000).astype(np.uint8)
    seq[::97] = k - 1  # wildcard cells in the windows
    positions = np.arange(0, seq.size - m + 1, 3)
    want = np.zeros((positions.size, g["t_eff"].shape[0]), np.int64)
    want[:, :count] = sum(d16[:, j, seq[positions + j]].T for j in range(m))
    want -= np.where(g["t_eff"] == multi.K3_NEVER, multi.K5_NEVER, g["t_eff"])
    # the CPU result is the reference the card is held to
    cpu = multi.group_to_device(g, torch.device("cpu"))
    planes, _, t_c = cpu["phase_c"]
    ref = multi.phase_c(torch.from_numpy(seq), torch.from_numpy(positions), planes, t_c)
    assert np.array_equal(ref.numpy(), want)
    group = multi.group_to_device(g, cuda)
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision(precision)
        part = multi.phase_c(torch.from_numpy(seq).to(cuda),
                             torch.from_numpy(positions).to(cuda),
                             group["phase_c"][0], group["phase_c"][2])
        torch.cuda.synchronize()
    finally:
        torch.set_float32_matmul_precision(saved)
    assert part.is_cuda and torch.equal(part.cpu(), ref)


def _extreme_tables(rng, name):
    """m = 128 DNA tables at the extremes: u16 cells up to 65535 (both
    bytes full) for K5, u8 cells up to 255 for K4, a never-pass lane."""
    m, k, count = 128, 5, 37
    if name == "prefilter_any16":
        stack = rng.normal(scale=4.0, size=(count, m, k)).astype(np.float32)
        stack[:, :, k - 1] = stack[:, :, : k - 1].max(axis=2) + 1e6  # clips to 65535
        d16 = multi.fine_discretize(stack)[0]
        assert d16.max() == 65535 and (d16 & 255).max() == 255
        t16 = rng.integers(0, 65536, size=count)
        t16[0] = 65536
        return multi.pack_filters_k5(d16, t16), m
    dm = rng.integers(0, 256, size=(count, m, k)).astype(np.float32)
    dm[:, ::3] = 255.0
    t_scaled = rng.integers(0, 256, size=count)
    t_scaled[0] = 300
    filters_t = multi_kernel.pack_filters_any(dm, t_scaled, k)
    return multi.pack_filters_k4(filters_t, k), m


@pytest.mark.parametrize("name", ["prefilter_any", "prefilter_any16"])
def test_k4_k5_kernels_match_plain_at_the_extremes(cuda, name):
    rng = np.random.default_rng(5)
    table, m = _extreme_tables(rng, name)
    seq = rng.integers(0, 5, size=100_000).astype(np.uint8)
    seq[::101] = 4  # wildcards in the windows
    seq_dev = torch.from_numpy(seq).to(cuda)
    args = _card_args(table, cuda)
    before = dict(multi_kernel.LAUNCHES)
    got = getattr(multi_kernel, name)(seq_dev, *args)
    want = getattr(torch_ops, name)(seq_dev, *args)
    torch.cuda.synchronize()
    assert multi_kernel.LAUNCHES[name] == before[name] + 1
    assert multi_kernel.LAUNCHES["prefilter_gmma"] == before["prefilter_gmma"] + 1
    n = seq.size - m + 1
    assert torch.equal(got[:n], want[:n])
    assert want[:n].unique().numel() > 100  # not vacuous


def test_batch_reducer_on_the_card_matches_the_cpu(cuda):
    rng = np.random.default_rng(9)
    (pssm,) = _motifs(rng, [15], DNA)
    records = [EncodedSequence(rng.integers(0, 5, size=int(n)).astype(np.uint8))
               for n in rng.integers(5, 3000, size=300)]
    got = batch.BatchReducer(pssm, records, device=cuda)
    want = batch.BatchReducer(pssm, records, device="cpu")
    assert np.array_equal(got.max().view(np.uint32), want.max().view(np.uint32))
    assert np.array_equal(got.argmax()[0], want.argmax()[0])


#: (name, K, motif rows) of the tensor-core prefilter's extreme cases
PLANE_SHAPES = [("dna_m2", 5, 2), ("dna_m128", 5, 128), ("protein_m32", 21, 32)]


def _extreme_planes(rng, k, m, n_planes, lanes=40):
    """Planes of ``n_planes`` bytes at their extremes: many cells at the
    largest value that plane count holds (window sums kept inside int32),
    thresholds near each lane's best sum, a never-pass lane, padded lanes."""
    top = min(256 ** n_planes - 1, ((1 << 31) - 1 - (1 << 25)) // (2 * m + 2))
    cells = rng.integers(0, top + 1, size=(lanes, m, k))
    cells[rng.random((lanes, m, k)) < 0.3] = top
    # row 0 of every lane spans the top byte after its shift
    cells[:, 0, 0] = max(top, 256 ** (n_planes - 1))
    cells[:, 0, 1] = 0
    best = cells.max(axis=2).sum(axis=1)
    t = best - rng.integers(0, best // 8 + 1)
    t[3] = 1 << 26
    m_pad = -(-lanes // 16) * 16
    full = np.zeros((m_pad, m, k), np.int64)
    full[:lanes] = cells
    t_eff = np.full(m_pad, 1 << 26, np.int64)
    t_eff[:lanes] = t
    return multi._plane_table(full, t_eff)


@pytest.mark.parametrize("n_planes", [1, 2, 3, 4])
@pytest.mark.parametrize("name,k,m", PLANE_SHAPES, ids=[c[0] for c in PLANE_SHAPES])
def test_tensor_core_prefilter_matches_plain_at_the_extremes(cuda, name, k, m, n_planes):
    rng = np.random.default_rng(10 * n_planes + m)
    packed = _extreme_planes(rng, k, m, n_planes)
    assert packed[0].shape[0] == n_planes
    seq = rng.integers(0, k, size=30_000).astype(np.uint8)
    seq[1000:1400] = k - 1  # a wildcard run
    s = torch.from_numpy(seq).to(cuda)
    args = _card_args(packed, cuda)
    want = torch_ops.prefilter_any8(s, *args)
    n = seq.size - m + 1
    # the three entry points (the warpgroup kernel)
    for fn in ("prefilter_any8", "prefilter_any", "prefilter_any16"):
        before = multi_kernel.LAUNCHES[fn]
        got = getattr(multi_kernel, fn)(s, *args)
        torch.cuda.synchronize()
        assert multi_kernel.LAUNCHES[fn] == before + 1
        assert torch.equal(got[:n], want[:n]), fn
    # every instantiation that fits the card's shared memory, both orientations
    ran = set()
    for v, (orient, *_rest) in enumerate(probes.VARIANTS):
        try:
            got = probes.prefilter_variant(v, s, *args[:3])
        except ValueError as err:  # shared memory past the card's limit
            assert "shared memory" in str(err)
            continue
        torch.cuda.synchronize()
        assert torch.equal(got[:n], want[:n]), probes.VARIANTS[v]
        ran.add(orient)
    assert ran == {"m", "n"}
    assert want[:n].unique().numel() > (4 if m == 2 else 100)  # not vacuous


def test_prefilter_launch_reads_nothing_back_from_the_card(cuda):
    # a launch takes its geometry from the tensors' shapes: under the sync
    # debug mode any read of a device value back to the host would raise
    rng = np.random.default_rng(2)
    packed = _extreme_planes(rng, 5, 16, 2, lanes=300)
    s = torch.from_numpy(rng.integers(0, 5, 50_000).astype(np.uint8)).to(cuda)
    args = _card_args(packed, cuda)
    torch.cuda.synchronize()
    saved = torch.cuda.get_sync_debug_mode()
    try:
        torch.cuda.set_sync_debug_mode("error")
        outs = [getattr(multi_kernel, fn)(s, *args)
                for fn in ("prefilter_any8", "prefilter_any", "prefilter_any16")]
    finally:
        torch.cuda.set_sync_debug_mode(saved)
    want = torch_ops.prefilter_any8(s, *args)
    assert all(torch.equal(o[: 50_000 - 15], want[: 50_000 - 15]) for o in outs)


def _database_groups(cuda, seed=0x1A5BA2):
    """The two group shapes of the benchmark's JASPAR-sized database, as
    ``MultiScanner`` packs it in 2,048-lane groups sorted by length: motifs
    of 5-16 rows (16 rows) and of 17-35 (48 rows), thresholds at 80% of
    each motif's best score.  Returns ``[(group on the card, its motif
    count)]``."""
    rng = np.random.default_rng(seed)
    lengths = np.concatenate([rng.integers(5, 17, 2048), rng.integers(17, 36, 2048)])
    stack = rng.normal(size=(lengths.size, 35, 5)).astype(np.float32)
    stack[:, :, 4] = stack[:, :, :4].min(axis=2)  # the wildcard column
    for i, m in enumerate(lengths):
        stack[i, m:] = 0.0
    ths = (0.8 * stack.max(axis=2).sum(axis=1)).astype(np.float32)
    ids = np.argsort(lengths, kind="stable")
    return [(multi.group_to_device(g, cuda), len(g_ids))
            for g_ids, g in multi.pack_database(stack, lengths, ths, ids, 5, 2048)]


def _gmma_cases(rng):
    """(case, wrapper, packed filters, K, rows) of the warpgroup kernel's
    card checks: K4 (one plane), K5 (never-pass lanes at 262144), protein K,
    the deepest DNA rows, and 32 lane tiles of 1 to 32 k-steps each (every
    depth of the deep shapes' loop of commit groups)."""
    out = []
    table, m = _extreme_tables(rng, "prefilter_any")
    out.append(("k4_one_plane", "prefilter_any", table, 5, m))
    table, m = _extreme_tables(rng, "prefilter_any16")
    out.append(("k5_never_pass", "prefilter_any16", table, 5, m))
    out.append(("protein_m32", "prefilter_any8", _extreme_planes(rng, 21, 32, 2, lanes=300), 21, 32))
    out.append(("dna_m128", "prefilter_any8", _extreme_planes(rng, 5, 128, 2, lanes=200), 5, 128))
    k, rows, tiles = 4, 256, 32
    cells = rng.integers(0, 65536, size=(tiles * 128, rows, k))
    for t in range(tiles):  # tile t: rows up to 8 (t + 1), t + 1 k-steps
        cells[t * 128:(t + 1) * 128, 8 * (t + 1):] = 0
    best = cells.max(axis=2).sum(axis=1)
    packed = multi._plane_table(cells, best - rng.integers(0, best // 16 + 1))
    assert multi_kernel.tile_ksteps(packed[1], k).tolist() == list(range(1, tiles + 1))
    out.append(("ksteps_1_to_32", "prefilter_any8", packed, k, rows))
    return out


@pytest.mark.parametrize("case", range(5), ids=["k4_one_plane", "k5_never_pass", "protein_m32",
                                                "dna_m128", "ksteps_1_to_32"])
def test_gmma_prefilter_matches_plain_and_mma_kernel(cuda, case):
    rng = np.random.default_rng(40 + case)
    _, name, packed, k, m = _gmma_cases(rng)[case]
    seq = rng.integers(0, k, size=40_000).astype(np.uint8)
    seq[5000:5300] = k - 1  # a wildcard run
    s = torch.from_numpy(seq).to(cuda)
    args = _card_args(packed, cuda)
    assert multi_kernel.gmma_takes(args[0])
    before = multi_kernel.LAUNCHES["prefilter_gmma"]
    got = getattr(multi_kernel, name)(s, *args)
    want = getattr(torch_ops, name)(s, *args)
    torch.cuda.synchronize()
    assert multi_kernel.LAUNCHES["prefilter_gmma"] == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got, _mma_kernel(name, s, args))
    n = seq.size - m + 1
    assert want[:n].unique().numel() > 100  # not vacuous


def test_gmma_prefilter_matches_at_the_database_groups_shapes(cuda):
    groups = [g for g, _ in _database_groups(cuda)]
    assert [g["k3"][0].shape[3] for g in groups] == [16, 48]
    rng = np.random.default_rng(11)
    s = torch.from_numpy(rng.integers(0, 4, size=300_000).astype(np.uint8)).to(cuda)
    for g in groups:
        got = multi_kernel.prefilter_any8(s, *g["k3"])
        torch.cuda.synchronize()
        assert torch.equal(got, torch_ops.prefilter_any8(s, *g["k3"]))
        assert torch.equal(got, _mma_kernel("prefilter_any8", s, g["k3"]))
        assert (got >= 0).any() and (got < 0).any()


def test_gmma_prefilter_repeated_ragged_launches(cuda):
    # many launches at counts of window starts that are no multiple of a
    # 128-position tile, each held to the plain version (the check P6's
    # unexplained wgmma race asked of any production wgmma kernel), at a
    # DNA database group's shape and at a deep protein group's (the loop of
    # commit groups; chip_smoke.py's)
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        from chip_smoke import deep_protein_group
    finally:
        sys.path.pop(0)
    rng = np.random.default_rng(12)
    dna = torch.from_numpy(rng.integers(0, 4, size=128_077 + 15).astype(np.uint8)).to(cuda)
    cases = {"dna": (_database_groups(cuda)[0][0], dna), "protein_deep": deep_protein_group()}
    assert not multi_kernel.gmma_deep(cases["dna"][0]["k3"][0].shape)
    assert multi_kernel.gmma_deep(cases["protein_deep"][0]["k3"][0].shape)
    before = multi_kernel.LAUNCHES["prefilter_gmma"]
    wrong = {}
    for shape, (group, s) in cases.items():
        for n in (130, 5000, 128_077):
            want = torch_ops.prefilter_any8(s[:n], *group["k3"])
            for _ in range(8):
                got = multi_kernel.prefilter_any8(s[:n], *group["k3"])
                wrong[shape, n] = wrong.get((shape, n), 0) + int((got != want).sum())
    print("gmma repeated ragged launches, wrong positions by (shape, starts):", wrong)
    assert sum(wrong.values()) == 0, wrong
    assert multi_kernel.LAUNCHES["prefilter_gmma"] == before + 48


def test_scan_multi_core_graph_replay_holds_the_hits(cuda):
    # scan_multi_core captured in a CUDA graph and replayed: the warpgroup
    # kernel's launch (its geometry from shapes, its blocks where they lie)
    # gives the eager path's counters and kept hits
    group, count = _database_groups(cuda)[1]  # motifs of 17-35 rows: few candidates
    rng = np.random.default_rng(13)
    m = group["m_max"]
    chunk = torch.from_numpy(rng.integers(0, 4, size=200_000).astype(np.uint8)).to(cuda)
    lanes = multi.lanes(group)
    n_valid = torch.zeros(lanes, dtype=torch.int32, device=cuda)
    n_valid[:count] = 200_000 - m + 1
    cap = 1 << 16
    want = multi.scan_multi_core(chunk, n_valid, group, 5, cap)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        multi.scan_multi_core(chunk, n_valid, group, 5, cap)  # warm the allocator
        with torch.cuda.graph(graph, stream=stream):
            got = multi.scan_multi_core(chunk, n_valid, group, 5, cap)
    torch.cuda.current_stream().wait_stream(stream)
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        counts = got[0].cpu()
        assert torch.equal(counts, want[0].cpu()) and int(counts[2]) > 0
        n_kept = int(counts[2])
        assert torch.equal(got[1][:, :n_kept].cpu(), want[1][:, :n_kept].cpu())


def test_gmma_routing_by_shape(cuda):
    from lightmotif_tpu_torch.ops import build

    lib = build.library()
    assert [lib.lm_prefilter_gmma_shape(f) for f in range(6)] == [
        multi_kernel.GMMA_HALF, multi_kernel.GMMA_LANES, multi_kernel.GMMA_KSTEP,
        multi_kernel.GMMA_MAX_KSTEPS, multi_kernel.GMMA_MAX_LANE_TILES,
        multi_kernel.GMMA_TWO_KSTEPS]
    # (planes, chunks, rows, K) -> taken: rows x K up to 1,024 bytes, up to
    # 8,192 lanes, 1 to 4 planes; K up to 256
    for shape, taken in [((2, 128, 16, 5), True), ((2, 4, 128, 8), True),
                         ((2, 4, 64, 16), True), ((2, 4, 66, 16), False),
                         ((2, 512, 16, 5), True), ((2, 513, 16, 5), False),
                         ((4, 2, 32, 21), True), ((1, 2, 4, 256), False)]:
        p, chunks, rows, k = shape
        planes = torch.zeros(p, chunks, 16, rows, k, dtype=torch.uint8, device=cuda)
        assert multi_kernel.gmma_takes(planes) == taken, shape
        geom = lib.lm_prefilter_gmma_geom(p, chunks, rows, k)
        assert (geom >= 0) == taken
        if taken:  # the host's positions per tile are the kernel's
            assert (geom >> 8) & 0xFFF == multi_kernel.gmma_tile_positions(planes.shape)
            assert geom >> 20 <= 232_448 and geom & 255 >= 16
    # a shape past the warpgroup kernel's 8,192 lanes goes to mma_kernel,
    # counted apart, and gives the plain version's values
    rng = np.random.default_rng(14)
    packed = _extreme_planes(rng, 5, 6, 2, lanes=8208)
    s = torch.from_numpy(rng.integers(0, 5, 20_000).astype(np.uint8)).to(cuda)
    args = _card_args(packed, cuda)
    assert not multi_kernel.gmma_takes(args[0])
    before = dict(multi_kernel.LAUNCHES)
    got = multi_kernel.prefilter_any8(s, *args)
    torch.cuda.synchronize()
    assert multi_kernel.LAUNCHES["prefilter_mma"] == before["prefilter_mma"] + 1
    assert multi_kernel.LAUNCHES["prefilter_gmma"] == before["prefilter_gmma"]
    assert torch.equal(got, torch_ops.prefilter_any8(s, *args))


def test_gmma_prefilter_refuses_missing_or_mismatched_blocks(cuda):
    # a launch on the card needs the blocks and their k-steps, and blocks
    # that do not match the k-steps are refused before anything is queued
    rng = np.random.default_rng(15)
    packed = _extreme_planes(rng, 5, 16, 2, lanes=300)
    s = torch.from_numpy(rng.integers(0, 5, 20_000).astype(np.uint8)).to(cuda)
    planes, chunk_m, t_eff, blocks, ksteps = _card_args(packed, cuda)
    before = dict(multi_kernel.LAUNCHES)
    for bad in ((), (blocks[:-1], ksteps), (blocks, (*ksteps[:-1], ksteps[-1] + 1)),
                (blocks, ksteps[:-1])):
        with pytest.raises(ValueError, match="blocks|ksteps"):
            multi_kernel.prefilter_any8(s, planes, chunk_m, t_eff, *bad)
    assert multi_kernel.LAUNCHES == before
    # the C entry point refuses a count that is not the k-steps' schedule
    from lightmotif_tpu_torch.ops import build

    out = torch.empty(s.shape[0], dtype=torch.int32, device=cuda)
    steps = (ctypes.c_int * len(ksteps))(*ksteps)
    err = build.library().lm_prefilter_any8(
        s.data_ptr(), s.shape[0], planes.data_ptr(), *planes.shape[:2], *planes.shape[3:],
        chunk_m.data_ptr(), t_eff.data_ptr(), blocks.data_ptr(), blocks.shape[0] - 1, steps,
        out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    assert err != 0


def test_probe_kernels_match_plain_on_the_card(cuda):
    # P6 at the JAX probe's depth (3 blocks) and at one block, on a count
    # of positions that is no multiple of the 128-position tile, launched
    # eight times each (a race between the TMA ring and its consumers once
    # gave wrong sums in some launches only); then the s8 extremes (sums of
    # +-384 * 128)
    probes.reset_launches()
    for blocks in (3, 1):
        filt, x = (torch.from_numpy(a).to(cuda)
                   for a in probes.mma_inputs(5000, seed=3, blocks=blocks))
        want = probes.mma_max_plain(filt, x)
        for kind in ("int8", "bf16"):
            f, xk = probes.mma_operands(filt, x, kind)
            for run in range(8):
                got = probes.mma_max(f, xk, kind)
                torch.cuda.synchronize()
                assert torch.equal(got, want), (blocks, kind, run)
    rng = np.random.default_rng(5)
    filt = torch.from_numpy(np.where(rng.random((2048, 384)) < 0.5, -128, 127).astype(np.int8))
    filt[7] = -128
    x = torch.from_numpy((rng.random((700, 384)) < 0.98).astype(np.int8))
    x[:5] = 1
    want = probes.mma_max_plain(filt, x)
    for kind in ("int8", "bf16"):
        got = probes.mma_max(*probes.mma_operands(filt.to(cuda), x.to(cuda), kind), kind)
        torch.cuda.synchronize()
        assert torch.equal(got.cpu(), want), kind
    rng = np.random.default_rng(4)
    packed = [torch.from_numpy(a).to(cuda) for a in _extreme_planes(rng, 5, 20, 2)]
    s = torch.from_numpy(rng.integers(0, 5, 40_000).astype(np.uint8)).to(cuda)
    got = probes.prefilter_lookup(s, probes.lookup_table(packed[0]), *packed[1:])
    torch.cuda.synchronize()
    want = torch_ops.prefilter_any8(s, *packed)
    assert torch.equal(got[: 40_000 - 19], want[: 40_000 - 19])
    assert probes.LAUNCHES == {"probe_mma_int8": 17, "probe_mma_bf16": 17,
                               "prefilter_lookup": 1, "prefilter_variant": 0,
                               "prefilter_bits": 0}


def _scoring_cases(rng):
    """(what, seq, f32 table, u8 table, n_scores): the bench genome with
    MX000001, and edge cases -- DNA m 15, 130 and 300, protein, K = 7 and
    K = 256 -- with wildcard runs, ranks >= K, ragged n_scores, lengths
    that fill no block, and a sequence that starts off its alignment."""
    (pssm,) = [CountMatrix.from_sequences(EncodedSequence.encode(p) for p in (
        "GTTGACCTTATCAAC", "GTTGATCCAGTCAAC")).to_freq(0.1).to_weight(None).to_scoring()]
    genome = np.random.default_rng(0xECC011).integers(0, 4, 4_641_652, dtype=np.int8)
    yield ("genome", genome.astype(np.uint8), pssm.data, pssm.to_discrete().data,
           genome.size - 14)
    for k, m in ((5, 15), (5, 130), (5, 300), (21, 10), (7, 12), (256, 3)):
        length = int(rng.integers(20_000, 40_000))
        s = rng.integers(0, min(k + 3, 256), size=length + 3).astype(np.uint8)
        for start in rng.integers(0, length - 300, size=8):
            s[start : start + int(rng.integers(1, 200))] = k - 1
        w = rng.normal(size=(m, k)).astype(np.float32)
        w[rng.random((m, k)) < 0.05] = -np.inf
        d = rng.integers(0, 256, size=(m, k)).astype(np.uint8)
        yield (f"k{k}m{m}", s, w, d, max(length - m + 1 - int(rng.integers(0, 900)), 0))


def test_scoring_instantiations_match_plain_on_the_card(cuda):
    rng = np.random.default_rng(21)
    scoring.reset_launches()
    checked = 0
    for what, s, w, d, n in _scoring_cases(rng):
        base = torch.from_numpy(s).to(cuda)
        for seq in (base, base[3:]):  # aligned, and 3 bytes off
            m, k = w.shape
            for table in (torch.from_numpy(w).to(cuda), torch.from_numpy(d).to(cuda)):
                discrete = table.dtype == torch.uint8
                plain = (torch_ops.score_u8 if discrete else torch_ops.score_f32)(seq, table, n)
                entry = (kernels.score_u8 if discrete else kernels.score_f32)(seq, table, n)
                torch.cuda.synchronize()
                assert torch.equal(entry, plain), (what, discrete)
                for v in range(len(scoring.VARIANTS)):
                    if scoring.accepts(v, discrete, m, k):
                        got = scoring.score_variant(v, seq, table, n)
                        torch.cuda.synchronize()
                        assert torch.equal(got, plain), (what, v, scoring.VARIANTS[v], discrete)
                        checked += 1
    assert scoring.LAUNCHES["score_variant"] == checked > 100


def test_k1_k2_launch_reads_nothing_back_from_the_card(cuda):
    rng = np.random.default_rng(3)
    seq = torch.from_numpy(rng.integers(0, 6, 100_003).astype(np.uint8)).to(cuda)
    tables = [torch.from_numpy(rng.normal(size=(15, 5)).astype(np.float32)).to(cuda),
              torch.from_numpy(rng.integers(0, 256, (15, 5)).astype(np.uint8)).to(cuda),
              torch.from_numpy(rng.normal(size=(40, 21)).astype(np.float32)).to(cuda)]
    for t in tables:  # the first call of a shape asks the library its shared memory
        (kernels.score_u8 if t.dtype == torch.uint8 else kernels.score_f32)(seq, t, 99_000)
    torch.cuda.synchronize()
    kernels.reset_launches()
    saved = torch.cuda.get_sync_debug_mode()
    try:
        torch.cuda.set_sync_debug_mode("error")
        outs = [(kernels.score_u8 if t.dtype == torch.uint8 else kernels.score_f32)(seq, t, 99_000)
                for t in tables]
    finally:
        torch.cuda.set_sync_debug_mode(saved)
    assert kernels.LAUNCHES == {"score_f32": 2, "score_u8": 1, "scan_segment": 0}
    for t, o in zip(tables, outs):
        plain = (torch_ops.score_u8 if t.dtype == torch.uint8 else torch_ops.score_f32)
        assert torch.equal(o, plain(seq, t, 99_000))


def test_scoring_probe_kernels_match_plain_on_the_card(cuda):
    rng = np.random.default_rng(6)
    seq = torch.from_numpy(rng.integers(0, 7, 300_001).astype(np.uint8)).to(cuda)
    w = torch.from_numpy(rng.normal(size=(15, 5)).astype(np.float32)).to(cuda)
    d = torch.from_numpy(rng.integers(0, 256, (15, 5)).astype(np.uint8)).to(cuda)
    scoring.reset_launches()
    for mode in scoring.DIAG_MODES:
        t = d if mode == "u8out" else w
        got = scoring.score_diag(mode, seq, t, 299_000)
        torch.cuda.synchronize()
        assert torch.equal(got, scoring.diag_plain(mode, seq, t, 299_000)), mode
    x = torch.from_numpy(rng.integers(0, 256, 32 * 9_999).astype(np.uint8)).to(cuda)
    for v, (op, _, _) in enumerate(scoring.CHAINS):
        table = scoring.chain_table(op, cuda)
        got = scoring.op_chain(v, x, table)
        torch.cuda.synchronize()
        assert torch.equal(got, scoring.chain_plain(v, x, table)), scoring.CHAINS[v]
    assert scoring.LAUNCHES == {"score_variant": 0,
                                "probe_score_diag": len(scoring.DIAG_MODES),
                                "probe_op_chain": len(scoring.CHAINS)}


def test_p9_bits_match_plain_on_the_card(cuda):
    rng = np.random.default_rng(19)
    packed = _extreme_planes(rng, 5, 16, 2, lanes=300)
    lanes = packed[2].shape[0]
    s = torch.from_numpy(rng.integers(0, 5, 60_000).astype(np.uint8)).to(cuda)
    args = [torch.from_numpy(a).to(cuda) for a in packed]
    n_valid = torch.from_numpy(rng.integers(0, 60_000, lanes).astype(np.int32)).to(cuda)
    probes.reset_launches()
    got = probes.prefilter_bits(s, *args, n_valid)
    torch.cuda.synchronize()
    want = probes.prefilter_bits_plain(s, *args, n_valid)
    assert probes.LAUNCHES["prefilter_bits"] == 1
    assert got.shape == (60_000, lanes // 16) and torch.equal(got, want)
    assert (want != 0).sum() > 1000  # not vacuous


def _stage_inputs(group, dseq, lengths):
    """Phase C's and the pairs kernel's inputs in a group's one-segment
    scan: chunk, lanes' valid windows (int32), the prefilter's output."""
    n_valid = np.maximum(dseq.length - np.asarray(lengths)[group["ids"]] + 1, 0)
    n_max = int(n_valid.max())
    chunk = dseq.data[: n_max + group["m_max"] - 1]
    lanes = (dseq.length + 1 - group["len_dev"]).clamp(0, n_max).to(torch.int32)
    return chunk, lanes, multi_kernel.prefilter_any8(chunk, *group["k3"])


@pytest.mark.parametrize("alphabet,widths", [(DNA, [5, 6, 8, 10, 12, 15, 20, 33] * 4),
                                             (PROTEIN, [5, 9, 14, 21, 32] * 4)],
                         ids=["dna", "protein"])
def test_phase_c_and_pairs_kernels_match_plain(cuda, alphabet, widths):
    # a database scan ratcheting up from a capacity of 64 keeps the CPU's
    # hits, and each group's two kernels equal their plain versions, at
    # capacities that fit and below the need
    rng = np.random.default_rng(23)
    motifs = _motifs(rng, widths, alphabet)
    ths = [p.score_distribution().score(1e-3) for p in motifs]
    k = len(alphabet.symbols)
    seq = EncodedSequence(rng.integers(0, k - 1, size=300_000).astype(np.uint8), alphabet)
    ms = MultiScanner(motifs, seq, ths, device=cuda, capacity=64)
    multi_stages.reset_launches()
    got = ms.scan_arrays(seq)
    launches = dict(multi_stages.LAUNCHES)
    want = MultiScanner(motifs, seq, ths, device="cpu").scan_arrays(seq)
    assert launches["phase_c_bits"] > len(ms._groups)
    assert launches["pairs_rescore"] == launches["phase_c_bits"] * multi_stages.PAIRS_KERNELS
    assert len(want[0]) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))
    for group in ms._groups:
        chunk, lanes, maxv = _stage_inputs(group, ms._dseq, ms.lengths)
        n = int((maxv >= 0).sum())
        for cap, cap_hits in ((n + 1000, 1 << 18), (max(n // 2, 1), 64)):
            cand, count = multi.compact_candidates(maxv, cap)
            bits, pcnt = multi_stages.phase_c_bits(chunk, cand, count, *group["phase_c"],
                                                   lanes)
            plain = multi_stages.phase_c_bits_plain(chunk, cand, count, *group["phase_c"], lanes)
            counts, packed = multi_stages.pairs_rescore(bits, pcnt, cand, count, chunk,
                                                        group["pssm"], group["th"], cap_hits)
            want_counts, want_packed = multi_stages.pairs_rescore_plain(
                plain, cand, count, chunk, group["pssm"], group["th"], cap_hits)
            torch.cuda.synchronize()
            rows, n_kept = min(n, cap), int(want_counts[2])
            assert torch.equal(bits[:rows], plain[:rows])
            assert torch.equal(pcnt, multi_stages.row_popcounts(plain, count))
            assert torch.equal(counts, want_counts) and n_kept > 0
            assert torch.equal(packed[:, :n_kept], want_packed[:, :n_kept])


#: Stage cases on inputs made here: (name, K, motif rows, lanes, byte planes,
#: candidates, share of the pairs that pass, slice hints).  The two
#: database-like groups (16 and 48 rows of 2,048 DNA lanes); long protein
#: windows of K = 20 and 25, whose runs and planes leave room for few warps
#: (13 and 7 lane chunks: slices they do not fill); rows with more pairs than
#: a row lists (one byte plane).
STAGE_CASES = [
    ("dna_16_rows", 5, 16, 2048, 2, 20_000, 0.002, (0, 4)),
    ("dna_48_rows", 5, 48, 2048, 2, 3_000, 0.002, (0, 16)),
    ("protein_k20_long", 20, 48, 208, 2, 2_000, 0.01, (0, 2)),
    ("protein_k25_long", 25, 32, 112, 2, 2_000, 0.01, (0, 1)),
    ("dense_rows", 5, 8, 256, 1, 3_000, 0.6, (0,)),
]


def _stage_inputs_of(cuda, k, m, lanes, n_planes, n_cand, share, seed):
    """Random phase C inputs: ranks with some >= K, ascending candidates
    (some whose windows run past the end), cells of ``n_planes`` bytes,
    thresholds at each lane's (1 - share) quantile of its candidates' sums,
    lanes' valid windows (some 0, some short); and a group stack for the
    rescore with fewer motifs than lanes."""
    rng = np.random.default_rng(seed)
    n_pos = max(4 * n_cand, 10_000)
    seq = rng.integers(0, k + 2, n_pos).astype(np.uint8)
    cand = np.concatenate([np.sort(rng.choice(n_pos - 3, n_cand - 3, replace=False)),
                           [n_pos - 3, n_pos - 2, n_pos - 1]]).astype(np.int64)
    cells = rng.integers(0, 256 ** n_planes, (lanes, m, k))
    ranks = np.minimum(seq.astype(np.int64), k - 1)
    ext = np.concatenate([ranks, np.full(m, k - 1)])
    sums = sum(cells[:, j, ext[cand + j]].T for j in range(m))  # [n_cand, lanes]
    t = np.quantile(sums, 1 - share, axis=0).astype(np.int64)
    planes, chunk_m, t_eff = multi._plane_table(cells, t)
    n_valid = np.full(lanes, n_pos, np.int32)
    n_valid[rng.choice(lanes, lanes // 8, replace=False)] = 0
    n_valid[rng.choice(lanes, lanes // 8, replace=False)] = rng.integers(1, n_pos, lanes // 8)
    n_motifs = max(1, lanes - 5)
    pssm = rng.normal(size=(n_motifs, m, k)).astype(np.float32)
    th = rng.normal(scale=0.5 * np.sqrt(m), size=n_motifs)
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    return (dev(seq), cand, tuple(dev(a) for a in (planes, chunk_m, t_eff)), dev(n_valid),
            dev(pssm), dev(th.astype(np.float32)))


@pytest.mark.parametrize("name,k,m,lanes,n_planes,n_cand,share,hints", STAGE_CASES,
                         ids=[c[0] for c in STAGE_CASES])
def test_stage_kernels_match_plain_at_the_edges(cuda, name, k, m, lanes, n_planes, n_cand,
                                                share, hints):
    # phase C (bits and row popcounts) and the pairs kernel equal their plain
    # versions: room to spare, a cap that is no multiple of the tile, a count
    # past the cap, no candidate at all; hit capacities with room, one that
    # cuts the pairs inside a row, and rows that list only their first slots
    seq, cand_np, pc, n_valid, pssm, th = _stage_inputs_of(
        cuda, k, m, lanes, n_planes, n_cand, share, sum(map(ord, name)))
    multi_stages.reset_launches()
    most = 0
    for cap, n in ((n_cand + 100, n_cand), (n_cand // 2 + 7, n_cand), (1000, 0)):
        cand = torch.zeros(cap, dtype=torch.int64)
        cand[: min(n, cap)] = torch.from_numpy(cand_np[: min(n, cap)])
        cand = cand.to(cuda)
        count = torch.tensor(n, dtype=torch.int64, device=cuda)
        want = multi_stages.phase_c_bits_plain(seq, cand, count, *pc, n_valid)
        rows = min(n, cap)
        for hint in hints:
            geometry = multi_stages.phase_c_geometry(pc[0], hint)
            assert hint == 0 or geometry["slice"] == hint
            bits, pcnt = multi_stages.phase_c_bits(seq, cand, count, *pc, n_valid, hint)
            torch.cuda.synchronize()
            assert torch.equal(bits[:rows], want[:rows]), (cap, n, hint, geometry)
            assert torch.equal(pcnt, multi_stages.row_popcounts(want, count))
        pairs = int(pcnt.sum())
        assert rows == 0 or pairs > 0  # not vacuous
        most = max(most, int(pcnt.max()))
        for cap_hits in (1 << 20, max(pairs // 3, 1) + 1, 64):
            got = multi_stages.pairs_rescore(bits, pcnt, cand, count, seq, pssm, th, cap_hits)
            ref = multi_stages.pairs_rescore_plain(want, cand, count, seq, pssm, th, cap_hits)
            torch.cuda.synchronize()
            n_kept = int(ref[0][2])
            assert torch.equal(got[0], ref[0]), (cap, n, cap_hits, got[0].tolist(),
                                                 ref[0].tolist())
            assert torch.equal(got[1][:, :n_kept], ref[1][:, :n_kept])
    assert name != "dense_rows" or most > multi_stages.slots_for(64)
    assert multi_stages.LAUNCHES["phase_c_bits"] == 3 * len(hints)
    assert multi_stages.LAUNCHES["pairs_rescore"] == 9 * multi_stages.PAIRS_KERNELS


def test_stage_kernels_list_a_rows_first_slots(cuda):
    # rows with more pairs than a row lists: every lane passes, so each row
    # holds 256 pairs and lists its first 64 at cap_hits 2**16; hit_need is
    # 4,096 x 256, and a cap_hits of 100 cuts the second row
    seq, cand_np, pc, n_valid, pssm, th = _stage_inputs_of(cuda, 5, 8, 256, 1, 500, 1.0, 5)
    n_valid.fill_(seq.shape[0])
    cand = torch.from_numpy(cand_np).to(cuda)
    count = torch.tensor(500, dtype=torch.int64, device=cuda)
    bits, pcnt = multi_stages.phase_c_bits(seq, cand, count, *pc, n_valid)
    assert int(pcnt.max()) == 256
    for cap_hits in (1 << 16, 100):
        got = multi_stages.pairs_rescore(bits, pcnt, cand, count, seq, pssm, th, cap_hits)
        ref = multi_stages.pairs_rescore_plain(bits, cand, count, seq, pssm, th, cap_hits)
        torch.cuda.synchronize()
        assert int(ref[0][1]) == 256 * 4096
        n_kept = int(ref[0][2])
        assert torch.equal(got[0], ref[0]) and n_kept > 0
        assert torch.equal(got[1][:, :n_kept], ref[1][:, :n_kept])


def test_database_dispatch_reads_nothing_back_from_the_card(cuda):
    # every group's stages and the dense motifs are issued with no read of
    # the card; the fetch reads it once
    rng = np.random.default_rng(29)
    motifs = _motifs(rng, [6, 9, 12, 20, 150], DNA)
    ths = [p.score_distribution().score(1e-4) for p in motifs]
    seq = EncodedSequence(rng.integers(0, 4, size=200_000).astype(np.uint8))
    ms = MultiScanner(motifs, seq, ths, device=cuda)
    want = ms.scan_arrays(seq)
    torch.cuda.synchronize()
    saved = torch.cuda.get_sync_debug_mode()
    try:
        torch.cuda.set_sync_debug_mode("error")
        token = ms.dispatch()
    finally:
        torch.cuda.set_sync_debug_mode(saved)
    ms.host_reads = 0
    got = ms.fetch(token)
    assert ms.host_reads == 1 and len(got[0]) > 0
    assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_stage_wrappers_launch_or_raise(cuda, monkeypatch):
    # with the kernels' build failing, a CUDA tensor gets the error, never
    # the plain version
    from lightmotif_tpu_torch.ops import build

    rng = np.random.default_rng(31)
    motifs = _motifs(rng, [6, 9, 12], DNA)
    k = len(DNA.symbols)
    stack, lengths = multi.stack_motifs([p.data for p in motifs], k)
    g = multi.pack_motif_group(np.arange(3), 3, int(lengths.max()), stack,
                               np.full(3, -3.0, np.float32), k)
    group = multi.group_to_device(g, cuda)
    chunk = torch.from_numpy(rng.integers(0, 4, 10_000).astype(np.uint8)).to(cuda)
    maxv = multi_kernel.prefilter_any8(chunk, *group["k3"])
    cand, count = multi.compact_candidates(maxv, 4096)
    lanes = torch.full((g["t_eff"].shape[0],), 9_000, dtype=torch.int32, device=cuda)
    bits, pcnt = multi_stages.phase_c_bits(chunk, cand, count, *group["phase_c"], lanes)
    torch.cuda.synchronize()

    def fail():
        raise RuntimeError("nvcc failed (a stand-in)")

    monkeypatch.setattr(build, "library", fail)
    before = dict(multi_stages.LAUNCHES)
    with pytest.raises(RuntimeError, match="a stand-in"):
        multi_stages.phase_c_bits(chunk, cand, count, *group["phase_c"], lanes)
    with pytest.raises(RuntimeError, match="a stand-in"):
        multi_stages.pairs_rescore(bits, pcnt, cand, count, chunk, group["pssm"], group["th"],
                                   4096)
    assert multi_stages.LAUNCHES == before


def _graph_scan_inputs(seed):
    rng = np.random.default_rng(seed)
    motifs = _motifs(rng, [6, 9, 12, 15, 20, 150], DNA)
    ths = [p.score_distribution().score(1e-4) for p in motifs]
    seqs = [EncodedSequence(rng.integers(0, 4, size=n).astype(np.uint8))
            for n in (200_000, 90_000)]
    return motifs, ths, seqs


def _same(got, want) -> bool:
    return all(a.dtype == b.dtype and np.array_equal(a.view(np.uint8), b.view(np.uint8))
               for a, b in zip(got, want))


def test_graph_replays_equal_the_eager_path_on_two_genomes(cuda):
    # two genomes, uploaded once each, bound in turn: the first scan of
    # each runs eagerly, the second captures, the rest replay; every scan
    # equals the eager path (``use_graphs`` off keeps a scanner eager) bit
    # for bit
    from lightmotif_tpu_torch.ops.pipeline import DeviceSequence

    motifs, ths, seqs = _graph_scan_inputs(37)
    seqs = [DeviceSequence(s, cuda) for s in seqs]
    eager = MultiScanner(motifs, thresholds=ths, device=cuda)
    eager.use_graphs = False
    want = [eager.scan_arrays(s) for s in seqs]
    assert eager.replays.captured == eager.replays.replayed == 0
    ms = MultiScanner(motifs, thresholds=ths, device=cuda)
    for _ in range(4):
        for s, w in zip(seqs, want):
            assert _same(ms.scan_arrays(s), w) and len(w[0])
    assert ms.replays.captured > 0 and ms.replays.replayed > 0
    # both tokens dispatched before either is fetched, and the same genome
    # twice: each token keeps its hits
    tokens = [ms.bind(s).dispatch() for s in (seqs[0], seqs[1], seqs[1])]
    for token, w in zip(reversed(tokens), (want[1], want[1], want[0])):
        assert _same(ms.fetch(token), w)


def test_graph_replays_after_an_overflow_capture_the_doubled_capacities(cuda):
    from lightmotif_tpu_torch.ops.pipeline import DeviceSequence

    motifs, ths, seqs = _graph_scan_inputs(38)
    seqs = [DeviceSequence(s, cuda) for s in seqs]
    want = [MultiScanner(motifs, thresholds=ths, device=cuda).scan_arrays(s) for s in seqs]
    ms = MultiScanner(motifs, thresholds=ths, capacity=1, device=cuda)
    multi.reset_reruns()
    assert _same(ms.scan_arrays(seqs[1]), want[1])
    small = dict(ms._group_state)
    for _ in range(3):  # at the settled capacities: eager, capture, replay
        assert _same(ms.scan_arrays(seqs[1]), want[1])
    captured = ms.replays.captured
    assert captured > 0 and multi.RERUNS["group"] > 0
    # the longer genome overflows the capacities the graphs hold: re-runs,
    # then new graphs at the doubled capacities
    for _ in range(3):
        assert _same(ms.scan_arrays(seqs[0]), want[0])
    assert any(ms._group_state[key] > small[key] for key in small)
    assert ms.replays.captured > captured
    for s, w in zip(seqs, want):
        assert _same(ms.scan_arrays(s), w)
    # each sequence keeps the graphs of its last capacities only
    for s in seqs:
        (held,) = ms.replays._sets[s].values()
        assert held[0] == ms._graph_key(ms._steps(s))


def test_graph_memory_stays_near_one_eager_scan(cuda):
    # the graphs of a steady scan keep about what one eager scan needs at
    # its peak (a capture reuses the memory its work frees), and what they
    # keep grows with the segments no faster than that peak does
    import gc

    from lightmotif_tpu_torch.ops.pipeline import DeviceSequence

    def settle():
        torch.cuda.synchronize(cuda)
        gc.collect()
        torch.cuda.empty_cache()

    rng = np.random.default_rng(40)
    motifs = _motifs(rng, [8, 12, 16, 20] * 50, DNA)
    ths = [p.score_distribution().score(1e-3) for p in motifs]
    genome = rng.integers(0, 4, size=8_000_019).astype(np.uint8)
    segment, rows, slack = 1_000_000, {}, 48 << 20
    for n_seg in (2, 8):
        seq = DeviceSequence(EncodedSequence(genome[: n_seg * segment + 19]), cuda)
        ms = MultiScanner(motifs, thresholds=ths, device=cuda)
        ms.SEGMENT = segment
        want = ms.scan_arrays(seq)
        ms.use_graphs = False  # eager
        settle()
        torch.cuda.reset_peak_memory_stats(cuda)
        base = torch.cuda.memory_allocated(cuda)
        assert _same(ms.scan_arrays(seq), want) and len(want[0])
        peak = torch.cuda.max_memory_allocated(cuda) - base
        ms.use_graphs = True
        settle()
        reserved = torch.cuda.memory_reserved(cuda)
        for _ in range(4):
            assert _same(ms.scan_arrays(seq), want)
        settle()
        kept = torch.cuda.memory_reserved(cuda) - reserved
        assert ms.replays.captured > 0 and ms.replays.replayed > 0
        assert kept <= 1.5 * peak + slack, (n_seg, kept, peak)
        rows[n_seg] = (peak, kept)
        del ms, seq
        settle()
    assert rows[8][1] - rows[2][1] <= 1.5 * max(rows[8][0] - rows[2][0], 0) + slack, rows


def test_graph_capture_on_the_second_card_while_the_first_is_current(cuda):
    if torch.cuda.device_count() < 2:
        pytest.skip("one card")
    motifs, ths, seqs = _graph_scan_inputs(39)
    want = MultiScanner(motifs, seqs[0], ths, device="cpu").scan_arrays(seqs[0])
    torch.cuda.set_device(0)
    ms = MultiScanner(motifs, thresholds=ths, device="cuda:1")
    for _ in range(3):
        assert _same(ms.scan_arrays(seqs[0]), want)
        assert torch.cuda.current_device() == 0
    assert ms.replays.captured > 0 and ms.replays.replayed > 0


def test_a_failing_capture_raises(cuda):
    from lightmotif_tpu_torch.ops import graphs

    class Owner:
        pass

    owner, replays = Owner(), graphs.Replays(cuda)
    x = torch.arange(10, device=cuda)

    def reads():
        return int(x.sum())  # a read of the card: refused inside a capture

    # the first issue runs eagerly
    assert replays.issue(owner, "tag", "key", "step", reads) == (45, False)
    with pytest.raises(RuntimeError):
        replays.issue(owner, "tag", "key", "step", reads)
    assert replays.captured == 0
    # the card is usable after the failed capture
    assert int((x * 2).sum()) == 90
    torch.cuda.synchronize()


@pytest.mark.parametrize("name,k,m,length,ranks,kind,cap_kind", SEGMENT_CASES,
                         ids=[c[0] for c in SEGMENT_CASES])
def test_scan_compact_kernel_matches_plain(cuda, name, k, m, length, ranks, kind, cap_kind):
    """The segment kernel (``kernels.scan_segment``: the discrete pass,
    compaction, rescore and keep in one launch) against its plain version,
    bit for bit: the counters, the kept hits (positions, f32 bits) and the
    best of them; at capacities below, at and above the candidate count,
    1, and on and inside a tile's candidates; DNA and protein, m = 1 and m
    = 300, ragged lengths, ranks >= K, no candidate, -inf and exact zero
    sums.  Its launch reads nothing back (sync debug mode)."""
    seq, dm, table, n, t_scaled, threshold, cap, count = segment_inputs(
        k, m, length, ranks, kind, cap_kind, seed=len(name) + m)
    args = [torch.from_numpy(a).to(cuda) for a in (seq, dm, table)]
    chunk, dm_t, table_t = args
    kernels.reset_launches()
    saved = torch.cuda.get_sync_debug_mode()
    try:
        torch.cuda.set_sync_debug_mode("error")
        counts, packed, best = kernels.scan_segment(chunk, n, dm_t, table_t, t_scaled,
                                                    threshold, cap)
    finally:
        torch.cuda.set_sync_debug_mode(saved)
    assert kernels.LAUNCHES == {"score_f32": 0, "score_u8": 0, "scan_segment": 1}
    want_counts, want_packed, want_best = torch_ops.scan_segment(chunk, n, dm_t, table_t,
                                                                 t_scaled, threshold, cap)
    torch.cuda.synchronize()
    assert torch.equal(counts, want_counts) and counts[0] == count
    n_kept = int(counts[1])
    assert torch.equal(packed[:, :n_kept], want_packed[:, :n_kept])
    assert torch.equal(best, want_best)
    assert best.tolist() == list(best_of_hits(packed[0, :n_kept].cpu().numpy(),
                                              packed[1, :n_kept].cpu().numpy()))
    if kind == "zeros":
        assert n_kept and bool((packed[1, :n_kept] == 0).any())  # +0.0 bits
    if kind == "none":
        assert counts.tolist() == [0, 0, 1]


def test_scanner_reads_the_card_once(cuda):
    """A steady ``Scanner.collect()`` and ``max()`` read the card once
    (the seeded capacity of 4 ratchets at the first), the issue never,
    and the hits equal the CPU's; the segment kernel launches once a
    segment, K2 never."""
    from lightmotif_tpu_torch.scanner import Scanner

    rng = np.random.default_rng(13)
    (pssm,) = _motifs(rng, [9], DNA)
    seq = EncodedSequence(rng.integers(0, 4, size=300_000).astype(np.uint8))
    want = [(h.position, h.score) for h in Scanner(pssm, seq, 2.0, device="cpu").collect()]
    sc = Scanner(pssm, seq, 2.0, capacity=4, block_size=65_536, device=cuda)
    assert [(h.position, h.score) for h in sc.collect()] == want and sc.capacity > 4
    kernels.reset_launches()
    sc.host_reads = 0
    assert [(h.position, h.score) for h in sc.collect()] == want
    assert sc.host_reads == 1
    segments = -(-(300_000 - 8) // 65_536)
    assert kernels.LAUNCHES == {"score_f32": 0, "score_u8": 0, "scan_segment": segments}
    best = Scanner(pssm, seq, 2.0, device="cpu").max()
    sc.host_reads = 0
    got = sc.max()
    assert (got.position, got.score) == (best.position, best.score) and sc.host_reads == 1
    saved = torch.cuda.get_sync_debug_mode()
    try:
        torch.cuda.set_sync_debug_mode("error")
        segs = sc._issue(sc._runs(int(sc.dm.scale(2.0)), 2.0))
    finally:
        torch.cuda.set_sync_debug_mode(saved)
    assert len(segs) == segments
