"""The port's multi-motif host packers against the JAX package's.

``lightmotif_tpu_torch.ops.multi`` / ``multi_kernel`` must give the
arrays of ``lightmotif_tpu.ops.multi`` / ``multi_kernel`` byte for byte
on the same numpy inputs (DNA and protein; ragged contraction blocks;
unreachable thresholds; a wildcard cell above the body maximum; an
all-zero middle block), and the port's own layouts (K3's table and
thresholds, the phase-C byte planes) must hold the same numbers.
"""

import numpy as np
import pytest

import lightmotif_tpu as jlm
from lightmotif_tpu.ops import kernels as jax_kernels
from lightmotif_tpu.ops import multi as jmulti
from lightmotif_tpu.ops import multi_kernel as jmk
from lightmotif_tpu_torch import convert
from lightmotif_tpu_torch.ops import multi, multi_kernel

from .torch_parity import assert_same_arrays, bits, motif_stack, random_motifs


def _ragged_widths(rng):
    # most motifs fit contraction block 0, a few reach block 1, two block 2
    return sorted([int(w) for w in rng.integers(6, 15, size=246)]
                  + [int(w) for w in rng.integers(17, 25, size=8)] + [33] * 2)


def _case(name):
    """(stack, thresholds, k, m_bucket, gm) of one packer case."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "ragged":
        stack, lengths = motif_stack(random_motifs(rng, _ragged_widths(rng)))
        ths = np.full(len(lengths), -20.0, np.float32)
        ths[:3] = 1e6  # never-pass lanes
        return stack, ths, 5, int(lengths.max()), len(lengths)
    if name == "protein":
        stack, lengths = motif_stack(
            random_motifs(rng, sorted(rng.integers(5, 33, size=37)), protein=True))
        ths = rng.uniform(-10.0, 5.0, size=len(lengths)).astype(np.float32)
        return stack, ths, 21, int(lengths.max()), 48  # padded group
    if name == "unreachable":
        data = np.asarray([[2.0, -3.0, -3.0, -3.0, 0.0],
                           [-1.0, 3.0, -1.0, -1.0, 0.0],
                           [-2.0, -2.0, 1.0, -2.0, 0.0]], np.float32)
        best = float(np.float32(np.float32(2.0) + np.float32(3.0)) + np.float32(1.0))
        ths = np.asarray([best, best + 0.1, np.inf, -np.inf], np.float32)
        return data[None].repeat(4, axis=0), ths, 5, 3, 4
    if name == "wildcard":
        data = np.asarray([[2.0, -3.0, -3.0, -3.0, 0.0],
                           [-1.0, -1.0, -1.0, -1.0, 0.0]], np.float32)
        data[1, 4] = 5.0  # a wildcard cell above the row's body maximum
        return data[None], np.asarray([1.5], np.float32), 5, 2, 1
    assert name == "zero_middle"
    m = 33
    stack = np.zeros((241, m, 5), np.float32)
    stack[:, :6, :4] = np.linspace(0.5, 2.0, 241)[:, None, None]
    stack[-1, :16, :4] = [1.0, 2.0, 3.0, 4.0]
    stack[-1, 16:32] = 0.25  # uniform rows: block 1 discretizes to zero
    stack[-1, 32, :4] = [5.0, 1.0, 1.0, 1.0]
    return stack, np.full(241, -5.0, np.float32), 5, m, 241


CASES = ["ragged", "protein", "unreachable", "wildcard", "zero_middle"]
JAX_KEYS = ["f_hi", "f_lo", "f_hi8", "f_lo8", "adj", "pssm", "th", "m_max",
            "count", "widths", "rsplits", "pre4"]


@pytest.mark.parametrize("name", CASES)
def test_pack_motif_group_matches_jax(name):
    stack, ths, k, m_bucket, gm = _case(name)
    ids = np.arange(min(gm, stack.shape[0]))
    want = jmulti.pack_motif_group(ids, gm, m_bucket, stack, ths, k)
    got = multi.pack_motif_group(ids, gm, m_bucket, stack, ths, k)
    for key in JAX_KEYS:
        assert_same_arrays(got[key], want[key], key)
    if name == "ragged":
        assert got["widths"] == (256, 128, 128)  # raggedness engages
    if name == "zero_middle":
        assert got["widths"][1] >= got["widths"][2] >= 128


@pytest.mark.parametrize("name", CASES)
def test_port_layouts_hold_the_jax_numbers(name):
    stack, ths, k, m_bucket, gm = _case(name)
    ids = np.arange(min(gm, stack.shape[0]))
    g = multi.pack_motif_group(ids, gm, m_bucket, stack, ths, k)
    d16, f16, off16 = jmulti.fine_discretize(g["pssm"])
    m_pad = g["adj"].shape[0]
    planes, chunk_m, t_k3 = g["k3"]
    lanes = multi_kernel.K3_LANES
    n_planes, rows = planes.shape[0], planes.shape[3]
    assert planes.dtype == np.uint8
    assert planes.shape == (n_planes, m_pad // lanes, lanes, rows, k)
    assert rows >= m_bucket and rows * k % multi_kernel.ROW_BYTES == 0
    full = np.zeros((m_pad, m_bucket, k), np.int64)
    full[:gm] = d16
    # the planes hold d16 less each (lane, row)'s minimum, in the fewest bytes
    shift = full.min(axis=2)
    cells = sum(planes[q].astype(np.int64) << (8 * q) for q in range(n_planes))
    cells = cells.reshape(m_pad, rows, k)
    assert np.array_equal(cells[:, :m_bucket], full - shift[:, :, None])
    assert not cells[:, m_bucket:].any()
    assert n_planes == max(1, -(-int(cells.max()).bit_length() // 8))
    # every row at or past a chunk's bound is zero
    by_chunk = cells.reshape(m_pad // lanes, lanes, rows, k)
    for c, mc in enumerate(chunk_m):
        assert not by_chunk[c, :, mc:].any() and (mc == 0 or by_chunk[c, :, mc - 1].any())
    # t_eff (phase C's) is the JAX adj without its byte-plane shift; K3's
    # thresholds lose the row shifts too
    rpb = jmk.MAX_MK // jmk._lanes_for(k)
    r_mo = np.zeros(m_pad, np.int64)
    for wd in g["widths"]:
        r_mo[m_pad - wd:] += rpb
    assert np.array_equal(g["t_eff"], 128 * 257 * r_mo - g["adj"][:, 0])
    assert np.array_equal(t_k3, g["t_eff"] - shift.sum(axis=1))
    # phase C: K3's planes, with never-pass and padded lanes at K5's never
    pc_planes, pc_chunk_m, t_c = g["phase_c"]
    assert np.array_equal(pc_planes, planes) and np.array_equal(pc_chunk_m, chunk_m)
    t_never = np.where(g["t_eff"] == multi.K3_NEVER, multi.K5_NEVER, g["t_eff"])
    assert np.array_equal(t_c, t_never - shift.sum(axis=1))


def test_host_helpers_match_jax():
    rng = np.random.default_rng(5)
    for protein in (False, True):
        motifs = random_motifs(rng, [3, 9, 1, 17, 40], protein=protein)
        k = motifs[0].alphabet.size
        mats = [np.asarray(p.data, np.float32) for p in motifs]
        for a, b in zip(multi.stack_motifs(mats, k), jmulti.stack_motifs(mats, k)):
            assert_same_arrays(a, b)
        stack, _ = jmulti.stack_motifs(mats, k)
        for a, b in zip(multi.fine_discretize(stack), jmulti.fine_discretize(stack)):
            assert_same_arrays(a, b)
        _, f16, off16 = jmulti.fine_discretize(stack)
        ths = np.asarray([-5.0, np.inf, -np.inf, 1e9, 3.0], np.float32)
        assert_same_arrays(multi.fine_thresholds(ths, f16, off16),
                           jmulti.fine_thresholds(ths, f16, off16))
        assert_same_arrays(multi.unreachable_thresholds(stack, ths),
                           jmulti.unreachable_thresholds(stack, ths))
        assert_same_arrays(multi_kernel.pack_slots(stack, k), jmk.pack_slots(stack, k))
        for p in motifs:
            for a, b in zip(multi.pack_dense_motif(p.data, k),
                            jmulti.pack_dense_motif(p.data, k)):
                assert_same_arrays(a, b)
    for m_g in (1, 15, 16, 17, 33):
        for rpb in (4, 16):
            for mg in (False, True):
                assert multi.group_bucket(m_g, rpb, mg) == jmulti.group_bucket(m_g, rpb, mg)
    assert multi.DENSE_BUCKET == jmulti.DENSE_BUCKET
    for name in ("BITS_PER_WORD", "MAX_MK", "LANES_PER_ROW", "LANES_PER_ROW_WIDE",
                 "ROWS_PER_BLOCK", "MAX_BLOCKS", "MAX_M_ROWS", "NEG_GUARD"):
        assert getattr(multi_kernel, name) == getattr(jmk, name), name
    for k in (2, 5, 8, 21, 32):
        assert multi_kernel._lanes_for(k) == jmk._lanes_for(k)


def test_supports_fused_is_the_jax_geometry():
    # the JAX predicate asks for a TPU unless its kernels interpret
    jax_kernels.INTERPRET = True
    try:
        for k in (5, 8, 21, 32):
            for m in (1, 2, 16, 32, 33, 128, 129):
                assert multi_kernel.supports_fused(m, k, 10) == jmk.supports_fused(m, k, 10)
    finally:
        jax_kernels.INTERPRET = False


def test_motif_set_carries_both_strands():
    rng = np.random.default_rng(11)
    motifs = random_motifs(rng, [6, 12, 20])
    ths = [p.score_distribution().score(1e-4) for p in motifs]
    pssms, tths = convert.motif_set(motifs, ths, both_strands=True)
    want = motifs + [p.reverse_complement() for p in motifs]
    assert len(pssms) == 6
    for got, ref in zip(pssms, want):
        assert np.array_equal(bits(got.data), bits(ref.data))
        assert got.alphabet.symbols == ref.alphabet.symbols
    assert tths.dtype == np.float32
    assert np.array_equal(tths, np.asarray(ths + ths, np.float32))
    one, none = convert.motif_set(motifs)
    assert none is None and len(one) == 3
    assert isinstance(one[0], type(pssms[0])) and not isinstance(one[0], jlm.ScoringMatrix)
