"""The port's multi-motif device stages against the JAX package's.

On one segment, ``lightmotif_tpu_torch.ops.multi.scan_multi_core`` (K3,
the candidates at a fixed capacity, the u16 phase-C test, the pairs, the
exact rescore and the keep mask) must give the counters of
``lightmotif_tpu.ops.multi.scan_multi_core`` (interpret mode) and keep
its hits, with the same (position, motif lane, f32 bits) in the same
order, at the default capacities and at capacities below the need; each
stage is also held to what it computes, and the plain versions of the
two kernels (``ops.multi_stages``) to the JAX phase-C words and to the
port's earlier stages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightmotif_tpu.ops import multi as jmulti
from lightmotif_tpu.ops import multi_kernel as jmk
from lightmotif_tpu_torch.ops import multi, multi_kernel, multi_stages

from .torch_parity import (  # noqa: F401  (interpret_mode is an autouse fixture)
    bits, interpret_mode, motif_stack, random_motifs, random_ranks)

#: The segment: a multiple of every tile the JAX prefilter picks.
TILE = 32768

#: (name, protein, motif widths, p-value of the thresholds)
CORE_CASES = [
    ("dna", False, [5, 6, 8, 9, 10, 12, 12, 14, 15, 16, 20, 27, 33], 1e-3),
    ("dna_dense_hits", False, [6, 8, 8, 11], 0.05),
    ("protein", True, [5, 7, 9, 12, 18, 25, 32], 1e-3),
]


def _setup(name, protein, widths, pvalue):
    rng = np.random.default_rng(sum(map(ord, name)))
    motifs = random_motifs(rng, widths, protein=protein)
    stack, lengths = motif_stack(motifs)
    ths = np.asarray([p.score_distribution().score(pvalue) for p in motifs], np.float32)
    k = stack.shape[2]
    m_max = int(lengths.max())
    ids = np.arange(len(motifs))
    g = multi.pack_motif_group(ids, len(ids), m_max, stack, ths, k)
    seq = random_ranks(rng, TILE, k, wildcard_runs=8)
    n_valid = np.zeros(g["t_eff"].shape[0], np.int64)
    n_valid[: len(ids)] = np.maximum(TILE - lengths + 1, 0)
    return g, k, m_max, seq, n_valid


def _assert_same_counts(counts, want_counts, g, seq, m_max) -> None:
    """The port's counters are the JAX core's, but for the wrap.

    The JAX prefilter's windows past the segment's end wrap around to its
    start (its BlockSpec reads tile ``(i + 1) % grid``); the port's read
    the wildcard there, as its windows past any chunk do.  The two agree
    on every window inside the segment, so ``hit_need``, ``n_kept`` and
    ``valid`` agree, and so do the hits; the candidate counter also counts
    the last ``m_max - 1`` window starts, and there each package counts
    the windows it reads: JAX's are K3's on the segment followed by its
    own first ``m_max - 1`` ranks, the port's K3's on the segment."""
    assert counts[1:].tolist() == want_counts[1:].tolist()
    group = multi.group_to_device(g, torch.device("cpu"))
    wrapped = np.concatenate([seq, seq[: m_max - 1]])
    n_port, n_jax = (
        int((multi_kernel.prefilter_any8(torch.from_numpy(x), *group["k3"])[: seq.size] >= 0)
            .sum()) for x in (seq, wrapped))
    assert counts[0] == n_port and want_counts[0] == n_jax


def _phase_c_thresholds(g) -> np.ndarray:
    """Phase C's thresholds before the row shifts: K3's (``t_eff``), with
    never-pass and padded lanes at K5's never (:func:`multi.pack_filters_k5`)."""
    return np.where(g["t_eff"] == multi.K3_NEVER, multi.K5_NEVER, g["t_eff"]).astype(np.int64)


def _jax_core(g, k, m_max, seq, n_valid, cap=TILE, cap_hits=1 << 16):
    """The JAX core's ``(counts, packed[:, :n_kept])`` on the segment."""
    counts, packed = jmulti.scan_multi_segment_fused(
        jnp.asarray(seq.astype(np.int8)), np.int32(0),
        jnp.asarray(n_valid.astype(np.int32)[None]), None,
        jnp.asarray(g["pssm"]), jnp.asarray(g["th"]), chunk_len=TILE, cap=cap,
        m_max=m_max, k=k, dense=False, cap_hits=cap_hits,
        filters_fine=(jnp.asarray(g["f_hi"]), jnp.asarray(g["f_lo"])),
        widths=g["widths"],
        filters_i8=(jnp.asarray(g["f_hi8"]), jnp.asarray(g["f_lo8"]),
                    jnp.asarray(g["adj"])),
        rsplits=None,
        pre4=None if g["pre4"] is None else jnp.asarray(g["pre4"]))
    counts = np.asarray(counts)
    return counts, np.asarray(packed)[:, : counts[2]]


def _port_core(g, k, seq, n_valid, cap=TILE, cap_hits=1 << 16):
    """The port's ``(counts, packed[:, :n_kept])`` on the segment."""
    group = multi.group_to_device(g, torch.device("cpu"))
    counts, packed = multi.scan_multi_core(torch.from_numpy(seq), torch.from_numpy(n_valid),
                                           group, k, cap, cap_hits)
    assert counts.dtype == packed.dtype == torch.int32
    assert tuple(counts.shape) == (4,) and tuple(packed.shape) == (3, cap_hits)
    counts = counts.numpy()
    return counts, packed.numpy()[:, : counts[2]]


@pytest.mark.parametrize("name,protein,widths,pvalue", CORE_CASES,
                         ids=[c[0] for c in CORE_CASES])
def test_scan_multi_core_matches_jax(name, protein, widths, pvalue):
    g, k, m_max, seq, n_valid = _setup(name, protein, widths, pvalue)
    want_counts, want = _jax_core(g, k, m_max, seq, n_valid)
    n_cand, hit_need, _, valid = want_counts.tolist()
    assert valid and n_cand <= TILE and hit_need <= 1 << 16  # no retry needed
    assert want.shape[1] > 0  # not vacuous
    counts, got = _port_core(g, k, seq, n_valid)
    assert got[0].tolist() == want[0].tolist()
    assert got[1].tolist() == want[1].tolist()
    assert got[2].view(np.uint32).tolist() == want[2].view(np.uint32).tolist()
    _assert_same_counts(counts, want_counts, g, seq, m_max)


#: Capacities below the need of every CORE_CASES segment (at least 211
#: candidates and pairs each): candidates, hits, both.
FORCED = {"cap": (100, 1 << 16), "cap_hits": (TILE, 64), "both": (100, 64)}


@pytest.mark.parametrize("forced", list(FORCED))
@pytest.mark.parametrize("name,protein,widths,pvalue", CORE_CASES,
                         ids=[c[0] for c in CORE_CASES])
def test_scan_multi_core_matches_jax_below_the_need(name, protein, widths, pvalue, forced):
    # the counters (the overflow flags among them) and the kept hits of an
    # overflowed run are the JAX core's too: the first cap candidates, each
    # row's first slots pairs, the first cap_hits pairs
    g, k, m_max, seq, n_valid = _setup(name, protein, widths, pvalue)
    cap, cap_hits = FORCED[forced]
    want_counts, want = _jax_core(g, k, m_max, seq, n_valid, cap, cap_hits)
    n_cand, hit_need, n_kept, _ = want_counts.tolist()
    assert n_cand > cap or hit_need > cap_hits  # an overflow
    assert n_kept > 0  # not vacuous
    counts, got = _port_core(g, k, seq, n_valid, cap, cap_hits)
    _assert_same_counts(counts, want_counts, g, seq, m_max)
    assert got.tolist() == want.tolist()


def _jax_phase_c_words(g, k, m_max, seq, n_valid, positions):
    """The JAX core's phase-C words of ``positions``, restated from
    ``lightmotif_tpu/ops/multi.py:868-920`` with its filters, ragged widths
    and bf16 matmuls: word ``w`` bit ``b`` set where lane ``16w + b`` passes
    inside its valid windows."""
    lanes = jmk._lanes_for(k)
    mk = jmk.MAX_MK
    fine_hi = jnp.asarray(g["f_hi"]).astype(jnp.bfloat16)
    fine_lo = jnp.asarray(g["f_lo"]).astype(jnp.bfloat16)
    n_blocks = fine_hi.shape[0] // mk
    m_pad = fine_hi.shape[1]
    rpb = mk // lanes
    chunk = jnp.asarray(seq.astype(np.int8))
    nib = k <= 16
    pwords = jmulti.pack_nibbles(chunk) if nib else jmulti.pack_words(chunk)
    pos = jnp.asarray(positions.astype(np.int32))
    win = jmulti.gather_windows(pwords, jnp.clip(pos, 0, TILE - 1), m_max, spw=8 if nib else 4)
    oh = win[:, :, None] == jnp.arange(lanes)[None, None, :]
    oh = jnp.pad(oh, ((0, 0), (0, n_blocks * rpb - m_max), (0, 0)))
    x = oh.reshape(pos.shape[0], n_blocks * mk).at[:, lanes - 1].set(True)
    xb = x.astype(jnp.bfloat16)
    dot = lambda a, b: jnp.dot(a, b, preferred_element_type=jnp.float32)  # noqa: E731
    hi, lo = dot(xb[:, :mk], fine_hi[:mk]), dot(xb[:, :mk], fine_lo[:mk])
    for b in range(1, n_blocks):
        s_b = m_pad - g["widths"][b]
        rows = slice(b * mk, (b + 1) * mk)
        hi = hi.at[:, s_b:].add(dot(xb[:, rows], fine_hi[rows, s_b:]))
        lo = lo.at[:, s_b:].add(dot(xb[:, rows], fine_lo[rows, s_b:]))
    mask = np.asarray((256.0 * hi + lo >= 0) & (pos[:, None] < n_valid[None, :]))
    weights = 1 << (np.arange(m_pad) % multi_kernel.BITS_PER_WORD)
    return (mask * weights).reshape(len(positions), -1, multi_kernel.BITS_PER_WORD).sum(
        axis=2).astype(np.int32)


@pytest.mark.parametrize("name,protein,widths,pvalue", CORE_CASES,
                         ids=[c[0] for c in CORE_CASES])
def test_phase_c_bits_plain_is_the_jax_phase_c(name, protein, widths, pvalue):
    g, k, m_max, seq, n_valid = _setup(name, protein, widths, pvalue)
    group = multi.group_to_device(g, torch.device("cpu"))
    chunk = torch.from_numpy(seq)
    maxv = multi_kernel.prefilter_any8(chunk, *group["k3"])
    n = int((maxv >= 0).sum())
    multi_stages.reset_launches()
    for cap in (n + 37, max(n // 2, 1)):  # room to spare, and fewer rows than candidates
        cand, count = multi.compact_candidates(maxv, cap)
        got, _ = multi_stages.phase_c_bits(chunk, cand, count, *group["phase_c"],
                                           torch.from_numpy(n_valid.astype(np.int32)))
        rows = min(n, cap)
        assert got.dtype == torch.int32 and tuple(got.shape) == (cap, g["t_eff"].shape[0] // 16)
        assert int(count) == n and not got[rows:].any()
        want = _jax_phase_c_words(g, k, m_max, seq, n_valid, cand[:rows].numpy())
        assert np.array_equal(got[:rows].numpy(), want) and want.any()
    assert set(multi_stages.LAUNCHES.values()) == {0}  # the plain version on the CPU


@pytest.mark.parametrize("name,protein,widths,pvalue", CORE_CASES,
                         ids=[c[0] for c in CORE_CASES])
def test_row_popcounts_are_the_jax_pcnt(name, protein, widths, pvalue):
    # phase_c_bits' second output, the rows' set bits that the pairs kernel
    # lists pairs by, is the JAX core's pcnt = sum(population_count(words))
    # of its phase-C words, exactly; rows past the count are 0 in both
    g, k, m_max, seq, n_valid = _setup(name, protein, widths, pvalue)
    group = multi.group_to_device(g, torch.device("cpu"))
    chunk = torch.from_numpy(seq)
    maxv = multi_kernel.prefilter_any8(chunk, *group["k3"])
    n = int((maxv >= 0).sum())
    for cap in (n + 37, max(n // 2, 1)):
        cand, count = multi.compact_candidates(maxv, cap)
        bits_, pcnt = multi_stages.phase_c_bits(chunk, cand, count, *group["phase_c"],
                                                torch.from_numpy(n_valid.astype(np.int32)))
        rows = min(n, cap)
        words = np.zeros((cap, bits_.shape[1]), np.int32)
        words[:rows] = _jax_phase_c_words(g, k, m_max, seq, n_valid, cand[:rows].numpy())
        want = np.asarray(jnp.sum(jax.lax.population_count(jnp.asarray(words)), axis=1))
        assert pcnt.dtype == torch.int32 and tuple(pcnt.shape) == (cap,)
        assert np.array_equal(pcnt.numpy(), want) and want.any()
        assert torch.equal(multi_stages.row_popcounts(bits_, count), pcnt)


@pytest.mark.parametrize("name,protein,widths,pvalue", CORE_CASES,
                         ids=[c[0] for c in CORE_CASES])
def test_pairs_rescore_plain_is_the_plain_stages(name, protein, widths, pvalue):
    # lm_pairs_rescore's plain version against the plain stages: phase C's
    # mask inside the lanes' valid windows, its pairs in (position, lane)
    # order, rescore_multi and the keep mask: the same pairs, f32 bits and
    # order, and the counters
    g, k, m_max, seq, n_valid = _setup(name, protein, widths, pvalue)
    group = multi.group_to_device(g, torch.device("cpu"))
    chunk = torch.from_numpy(seq)
    maxv = multi_kernel.prefilter_any8(chunk, *group["k3"])
    n = int((maxv >= 0).sum())
    cand, count = multi.compact_candidates(maxv, n + 5)
    planes, _, t_c = group["phase_c"]
    mask = ((multi.phase_c(chunk, cand[:n], planes, t_c) >= 0)
            & (cand[:n, None] < torch.from_numpy(n_valid)))
    rows, lanes = torch.nonzero(mask, as_tuple=True)
    pos = cand[rows]
    scores = multi.rescore_multi(chunk, group["pssm"], pos, lanes)
    keep = scores >= group["th"][lanes]
    bits_, pcnt = multi_stages.phase_c_bits(chunk, cand, count, *group["phase_c"],
                                            torch.from_numpy(n_valid.astype(np.int32)))
    counts, packed = multi_stages.pairs_rescore(bits_, pcnt, cand, count, chunk,
                                                group["pssm"], group["th"], 1 << 16)
    n_kept = int(keep.sum())
    assert counts.tolist() == [n, pos.shape[0], n_kept, 1] and n_kept
    assert packed[0, :n_kept].tolist() == pos[keep].tolist()
    assert packed[1, :n_kept].tolist() == lanes[keep].tolist()
    assert packed[2, :n_kept].tolist() == scores[keep].view(torch.int32).tolist()
    assert not packed[:, n_kept:].any()


@pytest.mark.parametrize("name,protein,widths,pvalue", CORE_CASES,
                         ids=[c[0] for c in CORE_CASES])
def test_each_stage_computes_its_formula(name, protein, widths, pvalue):
    g, k, m_max, seq, n_valid = _setup(name, protein, widths, pvalue)
    group = multi.group_to_device(g, torch.device("cpu"))
    chunk = torch.from_numpy(seq)
    maxv = multi_kernel.prefilter_any8(chunk, *group["k3"])
    cand, count = multi.compact_candidates(maxv, TILE)
    n = int(count)
    assert cand[:n].tolist() == np.nonzero(maxv.numpy() >= 0)[0].tolist()
    assert not cand[n:].any()
    cand = cand[:n]

    # phase C: sum16 - t of every (candidate, lane) with phase C's
    # thresholds; K3's value is the maximum over the lanes with K3's
    d16 = multi.fine_discretize(g["pssm"])[0].astype(np.int64)
    m_pad = g["t_eff"].shape[0]
    full = np.zeros((m_pad, m_max, k), np.int64)
    full[: d16.shape[0]] = d16
    ext = np.concatenate([seq.astype(np.int64), np.full(m_max, k - 1)])
    c = cand.numpy()
    sums = sum(full[:, j, ext[c + j]].T for j in range(m_max))
    want = sums - _phase_c_thresholds(g)
    planes, _, t_c = group["phase_c"]
    part = multi.phase_c(chunk, cand, planes, t_c)
    assert part.dtype == torch.int32 and np.array_equal(part.numpy(), want)
    assert np.array_equal((sums - g["t_eff"]).max(axis=1), maxv.numpy()[c])

    # the pass bits: the phase-C mask inside each lane's valid windows, 16
    # lanes to a word; its pairs in ascending (position, lane) order
    mask = (want >= 0) & (c[:, None] < n_valid[None, :])
    words, _ = multi_stages.phase_c_bits(chunk, cand, count, *group["phase_c"],
                                         torch.from_numpy(n_valid.astype(np.int32)))
    weights = 1 << (np.arange(m_pad) % 16)
    assert np.array_equal(words.numpy(), (mask * weights).reshape(n, -1, 16).sum(
        axis=2).astype(np.int32))
    rows, cols = np.nonzero(mask)
    pos, lanes = torch.from_numpy(c[rows]), torch.from_numpy(cols)
    key = pos.numpy() * m_pad + lanes.numpy()
    assert pos.numel() and (np.diff(key) > 0).all()

    # rescore: the JAX rescore's bits, with and without its prefix table
    # (the port has one path, which gives the same bits as both)
    jpos, jlanes = jnp.asarray(pos.numpy().astype(np.int32)), jnp.asarray(
        lanes.numpy().astype(np.int32))
    got = multi.rescore_multi(chunk, group["pssm"], pos, lanes)
    for pre4 in (None, g["pre4"]):
        ref = np.asarray(jmulti.rescore_multi(
            jnp.asarray(seq.astype(np.int8)), jnp.asarray(g["pssm"]), jpos, jlanes,
            pre4=None if pre4 is None else jnp.asarray(pre4)))
        assert np.array_equal(bits(got.numpy()), bits(ref))
    assert protein or g["pre4"] is not None  # the prefix-table case ran


def test_rescore_turns_negative_zero_positive_like_jax():
    # a one-row motif whose score is -0.0, in a three-row group: the
    # zero-padded rows add +0.0, so the score comes out +0.0 in both
    pssm = np.zeros((2, 3, 5), np.float32)
    pssm[0, 0] = [-0.0, 1.0, -1.0, 2.0, 0.0]
    pssm[1] = [[0.5, -0.5, -0.0, 1.0, 0.0]] * 3
    seq = np.asarray([0, 2, 0, 1, 3, 2, 0, 0], np.uint8)
    pos = np.asarray([0, 2, 1, 5, 0, 4], np.int64)
    lanes = np.asarray([0, 0, 1, 1, 1, 1], np.int64)
    ref = np.asarray(jmulti.rescore_multi(
        jnp.asarray(seq.astype(np.int8)), jnp.asarray(pssm),
        jnp.asarray(pos.astype(np.int32)), jnp.asarray(lanes.astype(np.int32))))
    got = multi.rescore_multi(torch.from_numpy(seq), torch.from_numpy(pssm),
                              torch.from_numpy(pos), torch.from_numpy(lanes))
    assert np.array_equal(bits(got.numpy()), bits(ref))
    assert bits(got.numpy())[0] == 0  # +0.0, not -0.0


def test_phase_c_is_exact_under_tf32_matmul():
    # cells up to 65535 (full hi and lo bytes, two planes) and the longest
    # fused rows: phase C sums the planes' integer cells, so no float32
    # matmul precision (TF32 included) changes a sum
    rng = np.random.default_rng(17)
    m, k, count = 128, 5, 37
    stack = rng.normal(scale=4.0, size=(count, m, k)).astype(np.float32)
    # wildcard cells far above the body: they clip to 65535
    stack[:, :, k - 1] = stack[:, :, : k - 1].max(axis=2) + 1e6
    g = multi.pack_motif_group(np.arange(count), count, m, stack,
                               np.full(count, -1e3, np.float32), k)
    d16 = multi.fine_discretize(g["pssm"])[0].astype(np.int64)
    assert d16.max() == 65535 and (d16 & 255).max() == 255
    seq = rng.integers(0, k, size=2000).astype(np.uint8)
    positions = torch.arange(0, 2000 - m + 1, 7)
    group = multi.group_to_device(g, torch.device("cpu"))
    ext = seq.astype(np.int64)
    p = positions.numpy()
    want = np.zeros((p.size, g["t_eff"].shape[0]), np.int64)
    want[:, :count] = sum(d16[:, j, ext[p + j]].T for j in range(m))
    want -= _phase_c_thresholds(g)
    planes, _, t_c = group["phase_c"]
    assert planes.shape[0] == 2  # both bytes of the cells
    saved = torch.get_float32_matmul_precision()
    try:
        for precision in ("highest", "high"):
            torch.set_float32_matmul_precision(precision)
            part = multi.phase_c(torch.from_numpy(seq), positions, planes, t_c)
            assert np.array_equal(part.numpy(), want), precision
    finally:
        torch.set_float32_matmul_precision(saved)
