"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and ``nvcc``; elsewhere they skip.  The
file imports neither JAX nor the JAX package, so it runs where only the
port is installed::

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from lightmotif_tpu_torch import DNA, PROTEIN, CountMatrix, EncodedSequence, batch
from lightmotif_tpu_torch.ops import multi, multi_kernel, torch_ops
from lightmotif_tpu_torch.probes import prefilter as probes
from lightmotif_tpu_torch.scanner import MultiScanner

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device: the kernels run only on the card")
    return torch.device("cuda")


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
    args = [torch.from_numpy(a).to(cuda) for a in g["k3"]]
    before = multi_kernel.LAUNCHES["prefilter_any8"]
    got = multi_kernel.prefilter_any8(seq_dev, *args)
    want = torch_ops.prefilter_any8(seq_dev, *args)
    torch.cuda.synchronize()
    assert multi_kernel.LAUNCHES["prefilter_any8"] == before + 1
    n = seq.size - m_max + 1
    assert torch.equal(got[:n], want[:n])


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
    # cells up to 65535 (full hi and lo bytes) and the longest fused rows;
    # "high" lets the matmul run in TF32 (11 significant bits), "medium" in
    # bf16 (8): the byte-plane operands keep at most 8 and every sum stays
    # below 2**24, so each precision gives the exact integers
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
    want -= g["t_eff"]
    # the CPU result is the reference the card is held to
    cpu = multi.group_to_device(g, torch.device("cpu"))
    ref = multi.phase_c(torch.from_numpy(seq), torch.from_numpy(positions),
                        cpu["fine"], cpu["t_eff"], m, k)
    assert np.array_equal(ref.numpy(), want)
    group = multi.group_to_device(g, cuda)
    saved = torch.get_float32_matmul_precision()
    try:
        torch.set_float32_matmul_precision(precision)
        part = multi.phase_c(torch.from_numpy(seq).to(cuda),
                             torch.from_numpy(positions).to(cuda),
                             group["fine"], group["t_eff"], m, k)
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
    args = [torch.from_numpy(a).to(cuda) for a in table]
    before = multi_kernel.LAUNCHES[name]
    got = getattr(multi_kernel, name)(seq_dev, *args)
    want = getattr(torch_ops, name)(seq_dev, *args)
    torch.cuda.synchronize()
    assert multi_kernel.LAUNCHES[name] == before + 1
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
    args = [torch.from_numpy(a).to(cuda) for a in packed]
    want = torch_ops.prefilter_any8(s, *args)
    n = seq.size - m + 1
    # the three entry points (the production instantiation)
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
            got = probes.prefilter_variant(v, s, *args)
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
    args = [torch.from_numpy(a).to(cuda) for a in packed]
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


def test_probe_kernels_match_plain_on_the_card(cuda):
    filt, x = (torch.from_numpy(a).to(cuda) for a in probes.mma_inputs(5000, seed=3))
    want = probes.mma_max_plain(filt, x)
    probes.reset_launches()
    for kind in ("u8", "bf16"):
        got = probes.mma_max(filt, x, kind)
        torch.cuda.synchronize()
        assert torch.equal(got, want), kind
    rng = np.random.default_rng(4)
    packed = [torch.from_numpy(a).to(cuda) for a in _extreme_planes(rng, 5, 20, 2)]
    s = torch.from_numpy(rng.integers(0, 5, 40_000).astype(np.uint8)).to(cuda)
    got = probes.prefilter_lookup(s, probes.lookup_table(packed[0]), *packed[1:])
    torch.cuda.synchronize()
    want = torch_ops.prefilter_any8(s, *packed)
    assert torch.equal(got[: 40_000 - 19], want[: 40_000 - 19])
    assert probes.LAUNCHES == {"probe_mma_u8": 1, "probe_mma_bf16": 1,
                               "prefilter_lookup": 1, "prefilter_variant": 0}
