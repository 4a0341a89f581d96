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
