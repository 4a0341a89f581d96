"""The port's two-pass ``Scanner`` on the CPU against the JAX package's.

``collect()`` must give the same hits -- positions, f32 score bits and
order -- as ``lightmotif_tpu.Scanner``, and ``max`` must agree in both
modes.
"""

import numpy as np
import pytest
import torch

import lightmotif_tpu as jlm
import lightmotif_tpu_torch as tlm
from lightmotif_tpu.ops import kernels as jax_kernels
from lightmotif_tpu.ops import xla_ops
from lightmotif_tpu_torch.ops import torch_ops

from .data import PATTERNS, SEQUENCE
from .torch_parity import (  # noqa: F401  (cpu_choice is a fixture)
    bits, cpu_choice, hit_keys, pssms, random_counts, random_ranks, sequences)


def _golden_pssms(pseudo=0.1):
    counts = jlm.CountMatrix.from_sequences(
        jlm.EncodedSequence.encode(p) for p in PATTERNS).data
    return pssms(counts, pseudo=pseudo)


@pytest.mark.usefixtures("cpu_choice")
def test_verify_golden_scan_twice():
    _, tp = _golden_pssms()
    seq = tlm.EncodedSequence.encode(SEQUENCE)
    for _ in range(2):  # a second call catches module/function shadowing
        hits = list(tlm.scan(tp, seq, threshold=-10.0))
        assert [h.position for h in hits] == [18, 27, 32]
        np.testing.assert_allclose([h.score for h in hits],
                                   [-5.50167, -6.43455, -8.9611], atol=1e-5)


def _threshold(host, kind):
    if kind == "sparse":
        return float(np.sort(host)[-25])
    if kind == "dense":
        return float(np.quantile(host[np.isfinite(host)], 0.2))
    return -np.inf  # every window is a candidate and a hit


#: (name, protein, m, length, pseudocount, threshold kind, port block_size)
SCAN_CASES = [
    ("sparse", False, 15, 20_000, 0.1, "sparse", None),
    ("dense", False, 15, 20_000, 0.1, "dense", None),
    ("all", False, 15, 5_000, 0.1, "all", None),
    ("neginf", False, 12, 20_000, 0.0, "sparse", None),
    ("protein", True, 10, 8_000, 0.1, "sparse", None),
    ("segments", False, 15, 40_000, 0.1, "sparse", 997),
]


@pytest.mark.parametrize(
    "name,protein,m,length,pseudo,kind,block",
    SCAN_CASES, ids=[c[0] for c in SCAN_CASES])
def test_collect_matches_jax(name, protein, m, length, pseudo, kind, block):
    k = 21 if protein else 5
    rng = np.random.default_rng(length + m)
    jp, tp = pssms(random_counts(rng, m, k), protein=protein, pseudo=pseudo)
    data = random_ranks(rng, length, k, wildcard_runs=10)
    if block is not None:
        # best windows straddling the port's seams and the JAX package's
        # (its segments are multiples of 8192 positions on the CPU)
        site = np.argmax(tp.data[:, : k - 1], axis=1).astype(np.uint8)
        for seam in (block, 5 * block, 17 * block, 8192, 16384, 24576):
            start = seam - m // 2
            data[start : start + m] = site
    js, ts = sequences(data, protein)
    host = tp.score_host(ts)
    threshold = _threshold(host, kind)
    jscan = jlm.Scanner(jp, js, threshold=threshold)
    if block is not None:
        jscan.block_size = 8192
    tscan = tlm.Scanner(tp, ts, threshold=threshold, device="cpu")
    if block is not None:
        tscan.block_size = block
    got, want = hit_keys(tscan.collect()), hit_keys(jscan.collect())
    assert got == want
    assert [p for p, _ in got] == sorted(p for p, _ in got)
    expected = np.nonzero(host >= np.float32(threshold))[0]
    assert [p for p, _ in got] == expected.tolist()
    if kind == "all":
        assert len(got) == length - m + 1
    if block is not None:
        seams = [p for p, _ in got if p % block > block - m]
        assert len(seams) >= 3, "hits must straddle the port's seams"


@pytest.mark.parametrize(
    "name,protein,m,length,pseudo,kind,block",
    SCAN_CASES, ids=[c[0] for c in SCAN_CASES])
def test_split_scan_segment_matches_jax(name, protein, m, length, pseudo, kind, block):
    """``scan_launch`` then ``scan_finish`` (and ``scan_segment``, the two
    in turn) on one segment -- the whole sequence, or the second block --
    against ``xla_ops.scan_segment`` at an exact capacity: the candidate
    count, the kept count and the kept hits in position order."""
    k = 21 if protein else 5
    rng = np.random.default_rng(length + m)
    jp, tp = pssms(random_counts(rng, m, k), protein=protein, pseudo=pseudo)
    data = random_ranks(rng, length, k, wildcard_runs=10)
    n_total = length - m + 1
    off, n_here = (0, n_total) if block is None else (block, block)
    threshold = _threshold(tp.score_host(sequences(data, protein)[1]), kind)
    dm = tp.to_discrete()
    t_scaled = int(dm.scale(threshold))
    pssm_t = torch.from_numpy(np.asarray(tp.data, np.float32))
    dm_t = torch.from_numpy(np.asarray(dm.data, np.uint8))
    chunk = torch.from_numpy(data[off : off + n_here + m - 1])

    mask, count = torch_ops.scan_launch(chunk, n_here, dm_t, t_scaled)
    positions, scores, keep = torch_ops.scan_finish(chunk, mask, int(count), pssm_t,
                                                    threshold)
    assert positions.shape == scores.shape == keep.shape == (int(count),)
    assert torch.equal(positions, torch.sort(positions).values)

    unit = jax_kernels.preferred_pad()
    chunk_len = xla_ops.pad_length(n_here, unit) + unit
    padded = np.full(max(off + chunk_len, length), k - 1, np.int8)
    padded[:length] = data
    counts, packed = xla_ops.scan_segment(
        padded, np.int32(off), np.int32(n_here), np.asarray(jp.to_discrete().data, np.uint8),
        np.asarray(jp.data, np.float32), np.int32(t_scaled), np.float32(threshold),
        chunk_len, 1 << max(n_here - 1, 1).bit_length(), True)
    want_count, want_kept, valid = np.asarray(counts).tolist()
    assert valid and (int(count), int(keep.sum())) == (want_count, want_kept)
    packed = np.asarray(packed)[:, :want_kept]
    kept = (positions[keep].numpy(), bits(scores[keep].numpy()))
    assert np.array_equal(kept[0], packed[0]) and np.array_equal(kept[1], bits(
        packed[1].view(np.float32)))
    got = torch_ops.scan_segment(chunk, n_here, dm_t, pssm_t, t_scaled, threshold)
    assert np.array_equal(got[0].numpy(), kept[0]) and np.array_equal(bits(got[1].numpy()),
                                                                       kept[1])
    if kind != "sparse":
        assert want_kept


@pytest.mark.parametrize("threshold", [-100.0, -10.0, 5.0, 100.0])
@pytest.mark.parametrize("mode", ["exact", "reference"])
def test_max_matches_jax(threshold, mode):
    jp, tp = _golden_pssms()
    js, ts = sequences(random_ranks(np.random.default_rng(9), 3000, 5, 5))
    got = tlm.Scanner(tp, ts, threshold=threshold, device="cpu").max(mode=mode)
    want = jlm.Scanner(jp, js, threshold=threshold).max(mode=mode)
    if want is None:
        assert got is None
    else:
        assert hit_keys([got]) == hit_keys([want])


def test_max_modes_match_jax_where_they_diverge():
    # the seed-0 / trial-10 case of tests/test_scan.py, where the
    # reference's rising cutoff skips the true best
    rng = np.random.default_rng(0)
    for _ in range(11):
        length = int(rng.integers(40, 400))
        text = "".join(rng.choice(list("ACTG"), length))
        m = int(rng.integers(4, 12))
        counts = rng.integers(0, 12, size=(m, 4))
        threshold = float(rng.uniform(-20, 2))
    counts = np.concatenate([counts, np.zeros((m, 1), int)], axis=1)
    jp, tp = pssms(counts)
    js, ts = sequences(jlm.EncodedSequence.encode(text).data)
    for mode in ("exact", "reference"):
        got = tlm.Scanner(tp, ts, threshold=threshold, device="cpu").max(mode=mode)
        want = jlm.Scanner(jp, js, threshold=threshold).max(mode=mode)
        assert hit_keys([got]) == hit_keys([want]), mode
    exact = tlm.Scanner(tp, ts, threshold=threshold, device="cpu").max()
    ref = tlm.Scanner(tp, ts, threshold=threshold, device="cpu").max(mode="reference")
    assert exact.score > ref.score


def test_capacity_is_accepted_for_api_parity():
    jp, tp = _golden_pssms()
    js, ts = sequences(jlm.EncodedSequence.encode(SEQUENCE).data)
    got = tlm.Scanner(tp, ts, threshold=-30.0, capacity=4, device="cpu").collect()
    want = jlm.Scanner(jp, js, threshold=-30.0, capacity=4).collect()
    assert hit_keys(got) == hit_keys(want)
