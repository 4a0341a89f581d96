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
from lightmotif_tpu_torch.ops import kernels as tkernels
from lightmotif_tpu_torch.ops import torch_ops

from .data import PATTERNS, SEQUENCE
from .torch_parity import (  # noqa: F401  (cpu_choice is a fixture)
    bits, cpu_choice, hit_keys, pssms, random_counts, random_ranks, sequences)
from .torch_segments import CASES as SEGMENT_CASES
from .torch_segments import best_of_hits, segment_inputs


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


def _segment_case(name, protein, m, length, pseudo, kind, block):
    """One segment of a scan case -- the whole sequence, or the second
    block -- in both packages' inputs."""
    k = 21 if protein else 5
    rng = np.random.default_rng(length + m)
    jp, tp = pssms(random_counts(rng, m, k), protein=protein, pseudo=pseudo)
    data = random_ranks(rng, length, k, wildcard_runs=10)
    n_total = length - m + 1
    off, n_here = (0, n_total) if block is None else (block, block)
    threshold = _threshold(tp.score_host(sequences(data, protein)[1]), kind)
    dm = tp.to_discrete()
    t_scaled = int(dm.scale(threshold))
    port = (torch.from_numpy(data[off : off + n_here + m - 1]), n_here,
            torch.from_numpy(np.asarray(dm.data, np.uint8)),
            torch.from_numpy(np.asarray(tp.data, np.float32)), t_scaled, threshold)
    unit = jax_kernels.preferred_pad()
    chunk_len = xla_ops.pad_length(n_here, unit) + unit
    padded = np.full(max(off + chunk_len, length), k - 1, np.int8)
    padded[:length] = data
    jax_args = (padded, np.int32(off), np.int32(n_here),
                np.asarray(jp.to_discrete().data, np.uint8), np.asarray(jp.data, np.float32),
                np.int32(t_scaled), np.float32(threshold), chunk_len)
    return port, jax_args


def _segment_parity(port, jax_args, cap):
    """``torch_ops.scan_segment`` and ``kernels.scan_segment`` against
    ``xla_ops.scan_segment`` (``dense=True``) at ``cap``, bit for bit: the
    candidate count, the kept count and the kept hits (positions and f32
    bits) in position order, and the best of the JAX package's kept hits
    (the largest score, the larger position among equal ones).  Returns
    the JAX counters."""
    counts, packed = xla_ops.scan_segment(*jax_args, cap, True)
    want = np.asarray(counts)
    n_kept = int(want[1])
    want_hits = np.asarray(packed)[:, :n_kept]
    for fn in (torch_ops.scan_segment, tkernels.scan_segment):
        got_counts, got_packed, got_best = fn(*port, cap)
        assert got_counts.dtype == got_packed.dtype == got_best.dtype == torch.int32
        assert got_packed.shape == (2, cap) and got_best.shape == (2,)
        assert got_counts.tolist() == [int(want[0]), n_kept, 1]
        assert np.array_equal(got_packed[:, :n_kept].numpy(), want_hits)
        assert tuple(got_best.tolist()) == best_of_hits(*want_hits)
    hits = want_hits[0]
    assert np.array_equal(hits, np.sort(hits))
    return want


def _jax_segment_args(data, dm, table, n_here, t_scaled, threshold):
    """``xla_ops.scan_segment``'s inputs for the whole of ``data`` as one
    segment (ranks as int8, padded with the wildcard)."""
    k = dm.shape[1]
    unit = jax_kernels.preferred_pad()
    chunk_len = xla_ops.pad_length(n_here, unit) + unit
    padded = np.full(max(chunk_len, data.shape[0]), k - 1, np.int8)
    padded[: data.shape[0]] = data
    return (padded, np.int32(0), np.int32(n_here), dm, table, np.int32(t_scaled),
            np.float32(threshold), chunk_len)


#: The segment cases the JAX package's int8 ranks hold, at most 60,000
#: window starts each on the CPU, with ranks inside the alphabet (an
#: encoded sequence holds no other; the card tests hold the kernel to its
#: plain version on ranks >= K too).  Not "zeros": XLA on the CPU folds
#: the JAX rescore's ``0.0 + x`` into ``x``, so a window of -0.0 cells
#: scores -0.0 there, where the JAX source, the reference and the port
#: add from +0.0 (the card tests hold the kernel's +0.0 to the plain one).
JAX_SEGMENT_CASES = [c for c in SEGMENT_CASES if c[1] < 128 and c[5] != "zeros"]


@pytest.mark.parametrize("name,k,m,length,ranks,kind,cap_kind", JAX_SEGMENT_CASES,
                         ids=[c[0] for c in JAX_SEGMENT_CASES])
def test_scan_segment_edges_match_jax(name, k, m, length, ranks, kind, cap_kind):
    """The plain segment scan (and the wrapper on the CPU) against
    ``xla_ops.scan_segment`` at the edges of the kernel's tiles and
    capacity (``tests/torch_segments.py``): DNA and protein tables, m = 1
    and m = 300, ragged lengths, no candidate, capacities of
    1, below, at and above the count, on and inside a tile's candidates,
    threshold -inf, wildcard runs; the best kept hit too."""
    seq, dm, table, n, t_scaled, threshold, cap, count = segment_inputs(
        k, m, min(length, 60_000), min(ranks, k), kind, cap_kind, seed=len(name) + m)
    port = (torch.from_numpy(seq), n, torch.from_numpy(dm), torch.from_numpy(table), t_scaled,
            threshold)
    want = _segment_parity(port, _jax_segment_args(seq, dm, table, n, t_scaled, threshold),
                           cap)
    assert want[0] == count
    if kind == "none":
        assert want.tolist() == [0, 0, 1]


@pytest.mark.parametrize(
    "name,protein,m,length,pseudo,kind,block",
    SCAN_CASES, ids=[c[0] for c in SCAN_CASES])
def test_split_scan_segment_matches_jax(name, protein, m, length, pseudo, kind, block):
    """The fixed-capacity segment scan (K2's plain version, then C3's) on
    one segment -- the whole sequence, or the second block -- against
    ``xla_ops.scan_segment`` at a capacity above the candidate count:
    every candidate is rescored, and the kept hits are the f32 threshold's."""
    port, jax_args = _segment_case(name, protein, m, length, pseudo, kind, block)
    chunk, n_here, dm_t, pssm_t, t_scaled, threshold = port
    count = int((torch_ops.score_u8(chunk, dm_t, n_here) >= t_scaled).sum())
    want = _segment_parity(port, jax_args, 1 << max(count - 1, 1).bit_length())
    assert want[0] == count
    host = torch_ops.score_f32(chunk, pssm_t, n_here)[:n_here]
    assert want[1] == int((host >= torch.tensor(threshold, dtype=torch.float32)).sum())
    if kind != "sparse":
        assert want[1]


@pytest.mark.parametrize("cap_kind", ["below", "at"])
@pytest.mark.parametrize(
    "name,protein,m,length,pseudo,kind,block",
    SCAN_CASES, ids=[c[0] for c in SCAN_CASES])
def test_scan_segment_at_a_capacity_matches_jax(name, protein, m, length, pseudo, kind, block,
                                               cap_kind):
    """The same at a capacity below the candidate count (the first
    ``cap`` candidates in position order, ``n_kept`` among them, the
    count still exact) and at the count itself."""
    port, jax_args = _segment_case(name, protein, m, length, pseudo, kind, block)
    chunk, n_here, dm_t, _, t_scaled, _ = port
    count = int((torch_ops.score_u8(chunk, dm_t, n_here) >= t_scaled).sum())
    cap = max(count // 3, 1) if cap_kind == "below" else max(count, 1)
    want = _segment_parity(port, jax_args, cap)
    assert want[0] == count and want[1] <= cap


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


@pytest.mark.parametrize("cap_kind", ["above", "below"])
@pytest.mark.parametrize("threshold", [-np.inf, -10.0, -5.0, "tie"])
def test_segment_best_matches_jax_max(threshold, cap_kind):
    """The segment scan's best kept hit (``torch_ops.scan_segment``'s
    third output, at the f32 threshold -inf that ``max()`` keeps with)
    against the JAX ``Scanner.max()``: ties go to the larger position
    (``tie``: the best window planted twice).  At a capacity below the
    candidate count, the best of the first ``cap`` candidates is the best
    of the JAX segment scan's kept hits at that capacity, and the port's
    ``Scanner.max()`` seeded at that capacity equals the JAX one's."""
    jp, tp = _golden_pssms()
    data = random_ranks(np.random.default_rng(9), 3000, 5, 5)
    tie = threshold == "tie"
    if tie:
        site = np.argmax(tp.data[:, :4], axis=1).astype(np.uint8)
        for start in (700, 2100):
            data[start : start + len(site)] = site
        threshold = 0.0
    js, ts = sequences(data)
    m = len(tp)
    n = len(data) - m + 1
    dm = np.asarray(tp.to_discrete().data, np.uint8)
    table = np.asarray(tp.data, np.float32)
    t_scaled = int(tp.to_discrete().scale(threshold))
    count = int((torch_ops.score_u8(torch.from_numpy(data), torch.from_numpy(dm), n)[:n]
                 >= t_scaled).sum())
    assert count > 3
    cap = 2 * count if cap_kind == "above" else max(count // 3, 1)
    counts, _, best = torch_ops.scan_segment(torch.from_numpy(data), n, torch.from_numpy(dm),
                                             torch.from_numpy(table), t_scaled, -np.inf, cap)
    bits_pos = tuple(best.tolist())
    if cap_kind == "above":
        want = jlm.Scanner(jp, js, threshold=threshold).max()
        assert bits_pos == (int(bits([want.score])[0].view(np.int32)), want.position)
        assert want.position == 2100 or not tie
    else:
        jcounts, jpacked = xla_ops.scan_segment(
            *_jax_segment_args(data, dm, table, n, t_scaled, -np.inf), cap, True)
        n_kept = int(np.asarray(jcounts)[1])
        assert int(counts[1]) == n_kept == cap
        assert bits_pos == best_of_hits(*np.asarray(jpacked)[:, :n_kept])
        got = tlm.Scanner(tp, ts, threshold=threshold, capacity=cap, device="cpu").max()
        want = jlm.Scanner(jp, js, threshold=threshold, capacity=cap).max()
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
    """The capacity is the JAX package's: the hits at a seed of 4 equal
    its hits, and ``Scanner.capacity`` after a scan equals its ratcheted
    value -- on one segment and on several, and again after a second
    ``collect()`` (which reads the device once and runs nothing again)."""
    jp, tp = _golden_pssms()
    js, ts = sequences(jlm.EncodedSequence.encode(SEQUENCE).data)
    got = tlm.Scanner(tp, ts, threshold=-30.0, capacity=4, device="cpu").collect()
    want = jlm.Scanner(jp, js, threshold=-30.0, capacity=4).collect()
    assert hit_keys(got) == hit_keys(want)
    rng = np.random.default_rng(20_000)
    jp, tp = pssms(random_counts(rng, 7, 5))
    js, ts = sequences(random_ranks(rng, 40_000, 5, wildcard_runs=10))
    # the JAX package's segments are multiples of 8192 positions on the CPU
    for block in (None, 8192):
        kw = {} if block is None else {"block_size": block}
        jscan = jlm.Scanner(jp, js, threshold=-5.0, capacity=4, **kw)
        tscan = tlm.Scanner(tp, ts, threshold=-5.0, capacity=4, device="cpu", **kw)
        for _ in range(2):
            want = hit_keys(jscan.collect())
            tscan.host_reads = 0
            reruns = tscan.reruns
            assert hit_keys(tscan.collect()) == want and len(want) > 10_000
            assert tscan.capacity == jscan.capacity > 4
        assert tscan.host_reads == 1 and tscan.reruns == reruns


@pytest.mark.parametrize("per_read", [1, 2, 5])
def test_read_ahead_bounds_the_segments_a_read_holds(per_read, monkeypatch):
    """Where :data:`~lightmotif_tpu_torch.scanner.READ_AHEAD` holds the
    hit buffers of ``per_read`` segments at the ratcheted capacity, a
    steady ``collect()`` or ``max()`` reads the device once per
    ``per_read`` segments, the re-runs of a first scan are issued
    ``per_read`` at a time, and the hits, the best hit and the capacity
    stay the JAX package's."""
    from lightmotif_tpu_torch import scanner as tscanner

    rng = np.random.default_rng(20_001)
    jp, tp = pssms(random_counts(rng, 7, 5))
    js, ts = sequences(random_ranks(rng, 40_000, 5, wildcard_runs=10))
    jscan = jlm.Scanner(jp, js, threshold=-5.0, capacity=4, block_size=8192)
    want = hit_keys(jscan.collect())
    tscan = tlm.Scanner(tp, ts, threshold=-5.0, capacity=4, block_size=8192, device="cpu")
    assert hit_keys(tscan.collect()) == want and tscan.capacity == jscan.capacity > 4
    monkeypatch.setattr(tscanner, "READ_AHEAD", 8 * tscan.capacity * per_read)
    segments = -(-(40_000 - 7 + 1) // 8192)
    tscan.host_reads = 0
    assert hit_keys(tscan.collect()) == want
    assert tscan.host_reads == -(-segments // per_read)
    tscan.host_reads = 0
    best, jbest = tscan.max(), jscan.max()
    assert (best.position, bits(best.score)) == (jbest.position, bits(jbest.score))
    assert tscan.host_reads == -(-segments // per_read) and tscan.capacity == jscan.capacity
    fresh = tlm.Scanner(tp, ts, threshold=-5.0, capacity=4, block_size=8192, device="cpu")
    issued, issue = [], tlm.Scanner._issue
    monkeypatch.setattr(tlm.Scanner, "_issue", lambda self, runs: (
        issued.append((len(runs), self.capacity)), issue(self, runs))[1])
    assert hit_keys(fresh.collect()) == want and fresh.capacity == jscan.capacity
    assert fresh.reruns == segments
    assert issued == [(segments, 4)] + [(min(per_read, segments - i), fresh.capacity)
                                        for i in range(0, segments, per_read)]
