"""The port's u8 and u16 prefilters K4 and K5 against the JAX package's.

The plain versions (``lightmotif_tpu_torch.ops.torch_ops.prefilter_any``
and ``prefilter_any16``, what the wrappers run on the CPU) must give the
values of the Pallas kernels ``lightmotif_tpu.ops.multi_kernel.
prefilter_any`` and ``prefilter_any16`` (interpret mode) on every
position ``p < Lp - m_max + 1``, sentinels included, from the port's
own packers: DNA with m_max 2, 15, 17 (ragged) and 39, protein, lanes
that never pass, padded lanes, a threshold row written by hand, K5 with
and without ragged widths, and wildcard cells above the body maximum.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightmotif_tpu.ops import multi as jmulti
from lightmotif_tpu.ops import multi_kernel as jmk
from lightmotif_tpu_torch.ops import multi, multi_kernel, torch_ops

from .torch_parity import (  # noqa: F401  (interpret_mode is an autouse fixture)
    interpret_mode, motif_stack, random_motifs, random_ranks)

#: Positions of the sequence: one Pallas tile.
LP = 4096

#: (name, protein, motif widths (None: 250 ragged DNA lanes), never-pass
#: lanes, wildcard cells above the body maximum)
CASES = [
    ("dna_m2", False, [2] * 5, 1, False),
    ("dna_m15", False, [5, 6, 8, 9, 10, 11, 12, 13, 14, 15, 15, 15, 15], 2, False),
    ("dna_m17_ragged", False, None, 3, False),
    ("dna_m39", False, [6, 10, 17, 25, 33, 39], 1, True),
    ("protein_m32", True, [5, 8, 12, 20, 27, 32], 1, False),
    ("protein_wild", True, [5, 7, 9, 11], 1, True),
]
IDS = [c[0] for c in CASES]


def _case(name, protein, widths, never, wild):
    """The JAX package's motif group and u8 inputs, and a sequence."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if widths is None:
        widths = sorted([int(w) for w in rng.integers(6, 16, size=244)]
                        + [int(w) for w in rng.integers(16, 18, size=6)])
    motifs = random_motifs(rng, widths, protein=protein)
    stack, lengths = motif_stack(motifs)
    k = stack.shape[2]
    if wild:  # wildcard cells far above each row's body maximum
        for j in range(stack.shape[1]):
            live = j < lengths
            stack[live, j, k - 1] = stack[live, j, : k - 1].max(axis=1) + 50.0
    # in the upper range of each motif's scores (a 2-mer has 16 windows)
    ths = np.asarray([p.score_distribution().score(max(0.02, 2 * 4.0 ** -len(p)))
                      for p in motifs], np.float32)
    ths[:never] = 1e6
    m_max = int(lengths.max())
    g = jmulti.pack_motif_group(np.arange(len(motifs)), len(motifs), m_max, stack, ths, k)
    # u8 inputs of K4: the discrete matrices and their scaled thresholds,
    # some above the u8 range (never pass)
    dms = [type(p)(p.alphabet, stack[i, : lengths[i]]).to_discrete()
           for i, p in enumerate(motifs)]
    dm_stack, _ = jmulti.stack_motifs([d.data.astype(np.float32) for d in dms], k)
    t_scaled = np.asarray([d.scale(t) for d, t in zip(dms, ths)], np.int64)
    t_scaled[:never] = 300
    seq = random_ranks(rng, LP, k, wildcard_runs=12)
    return g, dm_stack, t_scaled, k, m_max, seq


def _plain(name, seq, table):
    return getattr(multi_kernel, name)(
        torch.from_numpy(seq), *(torch.from_numpy(a) for a in table)).numpy()


@pytest.mark.parametrize("name,protein,widths,never,wild", CASES, ids=IDS)
def test_pack_filters_any_is_byte_identical(name, protein, widths, never, wild):
    _, dm_stack, t_scaled, k, _, _ = _case(name, protein, widths, never, wild)
    for got, want in ((multi_kernel.pack_filters(dm_stack, t_scaled, k),
                       jmk.pack_filters(dm_stack, t_scaled, k)),
                      ((multi_kernel.pack_filters_any(dm_stack, t_scaled, k),),
                       (jmk.pack_filters_any(dm_stack, t_scaled, k),))):
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name,protein,widths,never,wild", CASES, ids=IDS)
def test_prefilter_any_plain_matches_jax(name, protein, widths, never, wild):
    _, dm_stack, t_scaled, k, m_max, seq = _case(name, protein, widths, never, wild)
    filters_t = multi_kernel.pack_filters_any(dm_stack, t_scaled, k)
    want = np.asarray(jmk.prefilter_any(
        jnp.asarray(seq.astype(np.int8)), jnp.asarray(filters_t), m_max, k,
        tile=LP)).reshape(-1)
    table = multi.pack_filters_k4(filters_t, k)
    got = _plain("prefilter_any", seq, table)
    n = LP - m_max + 1
    assert got.dtype == np.int32 and got.shape == (LP,)
    assert np.array_equal(got[:n], want[:n])
    assert (got[:n] >= 0).any() and (got[:n] < 0).any()  # not vacuous
    # never-pass and padded lanes sit at NEG_GUARD
    t4 = table[2]
    assert (t4[:never] == 65536).all() and (t4[len(t_scaled):] == 65536).all()


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
@pytest.mark.parametrize("name,protein,widths,never,wild", CASES, ids=IDS)
def test_prefilter_any16_plain_matches_jax(name, protein, widths, never, wild, ragged):
    g, _, _, k, m_max, seq = _case(name, protein, widths, never, wild)
    want = np.asarray(jmk.prefilter_any16(
        jnp.asarray(seq.astype(np.int8)), jnp.asarray(g["f_hi"]),
        jnp.asarray(g["f_lo"]), m_max, k, tile=LP,
        widths=g["widths"] if ragged else None)).reshape(-1)
    # the port's K5 table, from the u16 cells and from the JAX filters
    port = multi.pack_motif_group(np.arange(g["count"]), g["count"], m_max,
                                  g["pssm"], g["th"], k)
    d16, f16, off16 = multi.fine_discretize(g["pssm"])
    t16 = np.where(multi.unreachable_thresholds(g["pssm"], g["th"]), 65536,
                   multi.fine_thresholds(g["th"], f16, off16))
    table = multi.pack_filters_k5(d16, t16)
    group = multi.group_from_filters(
        g["pssm"], g["th"], m_max, k, "cpu", filters_fine=(g["f_hi"], g["f_lo"]),
        widths=g["widths"] if ragged else None)
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(table, group["k5"]))
    got = _plain("prefilter_any16", seq, table)
    n = LP - m_max + 1
    assert np.array_equal(got[:n], want[:n])
    assert (got[:n] >= 0).any() and (got[:n] < 0).any()  # not vacuous
    # K5 is K3 but for the never-pass sentinel
    assert np.array_equal(table[0], port["k3"][0])
    assert (table[2][:never] == 262144).all() and (port["k3"][2][:never] == 1 << 26).all()
    if name == "dna_m17_ragged":
        assert g["widths"][1] < g["f_hi"].shape[1]  # raggedness engaged


def test_never_pass_k5_value_reaches_zero_on_wildcard_runs():
    # a never-pass lane's sum16 - 262144 passes 0 on a long wildcard run
    # when the wildcard cells exceed the body maximum: the JAX value, not
    # K3's (whose sentinel is 2**26)
    g, _, _, k, m_max, _ = _case(*CASES[3])
    seq = np.zeros(LP, np.uint8)
    seq[1000:1100] = k - 1
    d16 = multi.fine_discretize(g["pssm"])[0]
    t16 = np.full(g["count"], 65536)  # every lane never passes
    f_hi, f_lo = jmulti.pack_filters_fine(d16, t16, k)
    want = np.asarray(jmk.prefilter_any16(
        jnp.asarray(seq.astype(np.int8)), jnp.asarray(f_hi), jnp.asarray(f_lo),
        m_max, k, tile=LP)).reshape(-1)
    got = _plain("prefilter_any16", seq, multi.pack_filters_k5(d16, t16))
    n = LP - m_max + 1
    assert np.array_equal(got[:n], want[:n])
    assert (got[1000:1100 - m_max] >= 0).all() and (got[:900] < 0).all()


def test_prefilter_any_threshold_row_written_by_hand():
    # the bench's filters: random u8 cells, a zero wildcard column and
    # -2400 written into the constant slot of every lane
    rng = np.random.default_rng(11)
    m, k, count = 15, 5, 64
    dms = rng.integers(0, 200, size=(count, m, k)).astype(np.float32)
    dms[:, :, 4] = 0.0
    filters_t = jmk.pack_filters_any(dms, np.full(count, 2400, np.int64), k)
    filters_t[jmk._lanes_for(k) - 1, :] = -2400.0
    seq = rng.integers(0, 4, size=LP).astype(np.uint8)
    want = np.asarray(jmk.prefilter_any(
        jnp.asarray(seq.astype(np.int8)), jnp.asarray(filters_t), m, k,
        tile=LP)).reshape(-1)
    table = multi.pack_filters_k4(filters_t, k)
    # one plane; the zero wildcard column leaves every row unshifted; every
    # chunk needs all m rows
    assert table[0].shape[0] == 1 and (table[2] == 2400).all() and (table[1] == m).all()
    got = _plain("prefilter_any", seq, table)
    n = LP - m + 1
    assert np.array_equal(got[:n], want[:n])
    assert (got[:n] >= 0).any() and (got[:n] < 0).any()


def test_pack_filters_k4_rounds_through_bf16_and_refuses_what_jax_cannot_sum():
    k = 5
    filters_t = jmk.pack_filters_any(np.full((3, 4, k), 7.0, np.float32),
                                     np.asarray([10, 20, 400]), k)
    filters_t[0, 0] = 257.0  # bf16 rounds it to 256, as the JAX kernel does
    planes, chunk_m, t4 = multi.pack_filters_k4(filters_t, k)
    # every (lane, row) is shifted by its minimum, 7, which the thresholds
    # lose: lane 0's all-A window still scores 256 + 3 * 7 - 10
    assert planes.shape[0] == 1 and planes[0, 0, 0, 0, 0] == 256 - 7
    assert t4[:3].tolist() == [10 - 28, 20 - 28, 65536 - 28]
    assert int(planes[0, 0, 0, :, 0].astype(np.int64).sum()) - t4[0] == 256 + 3 * 7 - 10
    assert chunk_m.tolist() == [1]  # rows 1-3 of every lane shift to zero
    bad = filters_t.copy()
    bad[1, 1] = 0.5
    with pytest.raises(ValueError, match="integers"):
        multi.pack_filters_k4(bad, k)
    bad = filters_t.copy()
    bad[0, :] = bad[8, :] = 2.0 ** 23  # rows j = 0 and j = 1
    with pytest.raises(ValueError, match="2\\*\\*24"):
        multi.pack_filters_k4(bad, k)


@pytest.mark.parametrize("ragged", [False, True], ids=["full", "ragged"])
def test_jax_filters_unpack_to_the_port_cells(ragged):
    g, _, _, k, m_max, _ = _case(*CASES[2])
    widths = g["widths"] if ragged else (g["widths"][0],) * len(g["widths"])
    d16, f16, off16 = multi.fine_discretize(g["pssm"])
    t16 = np.where(multi.unreachable_thresholds(g["pssm"], g["th"]), 65536,
                   multi.fine_thresholds(g["th"], f16, off16))
    hi8, lo8, adj = multi.pack_filters_fine_i8(d16, t16, k, widths)
    # K3 with the fine filters for phase C, as the JAX MultiScanner passes them
    i8 = multi.group_from_filters(g["pssm"], g["th"], m_max, k, "cpu",
                                  filters_fine=(g["f_hi"], g["f_lo"]),
                                  filters_i8=(hi8, lo8, adj), widths=widths)
    k3 = multi.pack_filters_k3(d16, t16)
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(k3, i8["k3"]))
    assert "k5" not in i8
    fine = multi.group_from_filters(g["pssm"], g["th"], m_max, k, "cpu",
                                    filters_fine=(g["f_hi"], g["f_lo"]), widths=widths)
    k5 = multi.pack_filters_k5(d16, t16)
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(k5, fine["k5"]))
    # phase C reads the fine filters, with their thresholds, in both
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(k5, fine["phase_c"]))
    assert all(np.array_equal(a, b.numpy()) for a, b in zip(k5, i8["phase_c"]))


def _small(device="cpu"):
    rng = np.random.default_rng(3)
    motifs = random_motifs(rng, [5, 9, 12])
    stack, lengths = motif_stack(motifs)
    g = multi.pack_motif_group(np.arange(3), 3, int(lengths.max()), stack,
                               np.full(3, -5.0, np.float32), 5)
    seq = torch.from_numpy(random_ranks(rng, 3000, 5, wildcard_runs=3))
    return [t.to(device) for t in (seq, *(torch.from_numpy(a) for a in g["k3"]))]


@pytest.mark.parametrize("name", ["prefilter_any", "prefilter_any16"])
def test_cpu_wrappers_run_the_plain_version(name):
    seq, table, chunk_m, t_eff = _small()
    multi_kernel.reset_launches()
    got = getattr(multi_kernel, name)(seq, table, chunk_m, t_eff)
    assert torch.equal(got, getattr(torch_ops, name)(seq, table, chunk_m, t_eff))
    assert torch.equal(got, torch_ops.prefilter_any8(seq, table, chunk_m, t_eff))
    assert set(multi_kernel.LAUNCHES.values()) == {0}


@pytest.mark.parametrize("bad", ["seq_dtype", "table_dtype", "table_lanes",
                                 "chunk_m", "t_eff", "mixed_devices", "device"])
@pytest.mark.parametrize("name", ["prefilter_any", "prefilter_any16"])
def test_wrappers_refuse_what_the_kernel_does_not_take(name, bad):
    seq, table, chunk_m, t_eff = _small()
    if bad == "seq_dtype":
        seq = seq.to(torch.int8)
    elif bad == "table_dtype":
        table = table.to(torch.int64)
    elif bad == "table_lanes":
        table = table[:, :, :8]  # 8 of the 16 lanes of a chunk
    elif bad == "chunk_m":
        chunk_m = torch.cat([chunk_m, chunk_m])
    elif bad == "t_eff":
        t_eff = t_eff[:-1]
    elif bad == "mixed_devices":
        table = table.to("meta")
    else:  # a device with no kernel and no plain version: no fallback
        seq, table, chunk_m, t_eff = (t.to("meta") for t in (seq, table, chunk_m, t_eff))
    with pytest.raises((TypeError, ValueError), match=name):
        getattr(multi_kernel, name)(seq, table, chunk_m, t_eff)
