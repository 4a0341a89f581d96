"""The port's multi-motif device stages against the JAX package's.

On one segment, ``lightmotif_tpu_torch.ops.multi.scan_multi_core`` (K3,
candidates, the u16 phase-C test, pairs, the exact rescore and the keep
mask) must keep the hits of ``lightmotif_tpu.ops.multi.scan_multi_core``
(interpret mode), with the same (position, motif lane, f32 bits) in the
same order; each stage is also held to what it computes.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightmotif_tpu.ops import multi as jmulti
from lightmotif_tpu_torch.ops import multi, multi_kernel

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


def _jax_core(g, k, m_max, seq, n_valid):
    cap = TILE
    counts, packed = jmulti.scan_multi_segment_fused(
        jnp.asarray(seq.astype(np.int8)), np.int32(0),
        jnp.asarray(n_valid.astype(np.int32)[None]), None,
        jnp.asarray(g["pssm"]), jnp.asarray(g["th"]), chunk_len=TILE, cap=cap,
        m_max=m_max, k=k, dense=False, cap_hits=1 << 16,
        filters_fine=(jnp.asarray(g["f_hi"]), jnp.asarray(g["f_lo"])),
        widths=g["widths"],
        filters_i8=(jnp.asarray(g["f_hi8"]), jnp.asarray(g["f_lo8"]),
                    jnp.asarray(g["adj"])),
        rsplits=None,
        pre4=None if g["pre4"] is None else jnp.asarray(g["pre4"]))
    n_cand, hit_need, n_kept, valid = (int(v) for v in np.asarray(counts))
    assert valid and n_cand <= cap and hit_need <= 1 << 16  # no retry needed
    return np.asarray(packed)[:, :n_kept]


@pytest.mark.parametrize("name,protein,widths,pvalue", CORE_CASES,
                         ids=[c[0] for c in CORE_CASES])
def test_scan_multi_core_matches_jax(name, protein, widths, pvalue):
    g, k, m_max, seq, n_valid = _setup(name, protein, widths, pvalue)
    want = _jax_core(g, k, m_max, seq, n_valid)
    assert want.shape[1] > 0  # not vacuous
    group = multi.group_to_device(g, torch.device("cpu"))
    pos, lanes, scores = multi.scan_multi_core(
        torch.from_numpy(seq), torch.from_numpy(n_valid), group, k)
    assert pos.numpy().tolist() == want[0].tolist()
    assert lanes.numpy().tolist() == want[1].tolist()
    assert bits(scores.numpy()).tolist() == want[2].view(np.uint32).tolist()


@pytest.mark.parametrize("name,protein,widths,pvalue", CORE_CASES,
                         ids=[c[0] for c in CORE_CASES])
def test_each_stage_computes_its_formula(name, protein, widths, pvalue):
    g, k, m_max, seq, n_valid = _setup(name, protein, widths, pvalue)
    group = multi.group_to_device(g, torch.device("cpu"))
    chunk = torch.from_numpy(seq)
    maxv = multi_kernel.prefilter_any8(chunk, *group["k3"])
    cand = multi.candidates(maxv)
    assert cand.tolist() == np.nonzero(maxv.numpy() >= 0)[0].tolist()

    # phase C: sum16 - t_eff of every (candidate, lane), and K3's value is
    # its maximum over the lanes
    d16 = multi.fine_discretize(g["pssm"])[0].astype(np.int64)
    m_pad = g["t_eff"].shape[0]
    full = np.zeros((m_pad, m_max, k), np.int64)
    full[: d16.shape[0]] = d16
    ext = np.concatenate([seq.astype(np.int64), np.full(m_max, k - 1)])
    c = cand.numpy()
    want = sum(full[:, j, ext[c + j]].T for j in range(m_max)) - g["t_eff"]
    part = multi.phase_c(chunk, cand, group["fine"], group["t_eff"], m_max, k)
    assert part.dtype == torch.int32 and np.array_equal(part.numpy(), want)
    assert np.array_equal(part.numpy().max(axis=1), maxv.numpy()[c])

    # pairs: the phase-C mask inside each lane's valid windows, ascending
    # (position, lane)
    pos, lanes = multi.phase_c_pairs(chunk, cand, torch.from_numpy(n_valid), group, k)
    mask = (want >= 0) & (c[:, None] < n_valid[None, :])
    rows, cols = np.nonzero(mask)
    assert pos.tolist() == c[rows].tolist() and lanes.tolist() == cols.tolist()
    key = pos.numpy() * m_pad + lanes.numpy()
    assert (np.diff(key) > 0).all()

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
    # cells up to 65535 (full hi and lo bytes) and the longest fused rows:
    # the byte planes keep every operand exact in TF32 and every sum
    # below 2**24
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
    want -= g["t_eff"]
    saved = torch.get_float32_matmul_precision()
    try:
        for precision in ("highest", "high"):
            torch.set_float32_matmul_precision(precision)
            part = multi.phase_c(torch.from_numpy(seq), positions, group["fine"],
                                 group["t_eff"], m, k)
            assert np.array_equal(part.numpy(), want), precision
    finally:
        torch.set_float32_matmul_precision(saved)
