"""Every prefilter mode of the port's database-scan core against the JAX
package's.

``lightmotif_tpu_torch.ops.multi.scan_multi_segment_fused`` takes the
JAX filter arguments as they come and picks the prefilter in the JAX
order: ``filters_i8`` runs K3, else ``filters_fine`` K5, else the u8
``filters_t`` K4.  Its kept hits must be the JAX
``scan_multi_segment_fused``'s (interpret mode) in each mode: positions,
motif lanes and f32 bits, in the same order.  Without wildcards the
three modes keep the same hits; with them, a wildcard cell above the
body maximum saturates at 255 in the u8 discretization, so the u8 mode
is held to the JAX u8 mode alone.  In every mode the phase-C pairs
contain the kept hits.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightmotif_tpu.ops import multi as jmulti
from lightmotif_tpu.ops import multi_kernel as jmk
from lightmotif_tpu_torch.ops import multi, multi_kernel

from .torch_parity import (  # noqa: F401  (interpret_mode is an autouse fixture)
    bits, interpret_mode, motif_stack, multi_triples, random_motifs, random_ranks)

#: The segment: a multiple of every tile the JAX prefilters pick.
TILE = 32768

MODES = ["k3", "k5", "k4"]

#: (name, protein, motif widths, p-value of the thresholds, wildcard runs)
CASES = [
    ("dna", False, [5, 6, 8, 9, 10, 12, 12, 14, 15, 16, 20, 27, 33], 1e-3, 0),
    ("dna_wild", False, [6, 8, 8, 11, 13, 17], 1e-2, 10),
    ("protein", True, [5, 7, 9, 12, 18, 25, 32], 1e-3, 0),
]
IDS = [c[0] for c in CASES]


def _setup(name, protein, widths, pvalue, wild):
    rng = np.random.default_rng(sum(map(ord, name)))
    motifs = random_motifs(rng, widths, protein=protein)
    stack, lengths = motif_stack(motifs)
    ths = np.asarray([p.score_distribution().score(pvalue) for p in motifs], np.float32)
    ths[1] = 1e6  # a lane that never passes
    k = stack.shape[2]
    m_max = int(lengths.max())
    g = jmulti.pack_motif_group(np.arange(len(motifs)), len(motifs), m_max, stack, ths, k)
    dms = [p.to_discrete() for p in motifs]
    dm_stack, _ = jmulti.stack_motifs([d.data.astype(np.float32) for d in dms], k)
    t_scaled = np.asarray([d.scale(t) for d, t in zip(dms, ths)], np.int64)
    seq = random_ranks(rng, TILE, k, wildcard_runs=wild)
    n_valid = np.zeros(g["f_hi"].shape[1], np.int64)
    n_valid[: len(motifs)] = np.maximum(TILE - lengths + 1, 0)
    args = {
        "filters_t": jmk.pack_filters_any(dm_stack, t_scaled, k),
        "filters_fine": (g["f_hi"], g["f_lo"]),
        "widths": g["widths"],
        "filters_i8": (g["f_hi8"], g["f_lo8"], g["adj"]),
        "discrete": (dm_stack, t_scaled),
    }
    return g, k, m_max, seq, n_valid, args


def _mode_args(mode, args):
    """The JAX filter arguments of one mode, as its callers pass them."""
    if mode == "k3":  # MultiScanner: i8 with the fine filters for phase C
        return {"filters_t": None, "filters_fine": args["filters_fine"],
                "widths": args["widths"], "filters_i8": args["filters_i8"]}
    if mode == "k5":
        return {"filters_t": None, "filters_fine": args["filters_fine"],
                "widths": args["widths"]}
    return {"filters_t": args["filters_t"]}


def _jax(mode, g, k, m_max, seq, n_valid, args):
    kw = _mode_args(mode, args)
    filters_t = kw.pop("filters_t")
    jkw = {key: (tuple(jnp.asarray(a) for a in v) if isinstance(v, tuple)
                 and key != "widths" else v) for key, v in kw.items()}
    counts, packed = jmulti.scan_multi_segment_fused(
        jnp.asarray(seq.astype(np.int8)), np.int32(0),
        jnp.asarray(n_valid.astype(np.int32)[None]),
        None if filters_t is None else jnp.asarray(filters_t),
        jnp.asarray(g["pssm"]), jnp.asarray(g["th"]), chunk_len=TILE, cap=TILE,
        m_max=m_max, k=k, dense=False, cap_hits=1 << 18, **jkw)
    n_cand, hit_need, n_kept, valid = (int(v) for v in np.asarray(counts))
    assert valid and n_cand <= TILE and hit_need <= 1 << 18  # no retry needed
    return np.asarray(packed)[:, :n_kept]


def _port(mode, g, k, m_max, seq, n_valid, args):
    kw = _mode_args(mode, args)
    return multi.scan_multi_segment_fused(
        torch.from_numpy(seq), 0, n_valid[None], kw.pop("filters_t"), g["pssm"],
        g["th"], chunk_len=TILE, cap=TILE, m_max=m_max, k=k, cap_hits=1 << 18, **kw)


def _triples(pos, lanes, scores):
    return list(zip(pos.tolist(), lanes.tolist(), bits(scores.numpy()).tolist()))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,protein,widths,pvalue,wild", CASES, ids=IDS)
def test_segment_entry_matches_jax_in_each_mode(name, protein, widths, pvalue, wild,
                                                mode):
    g, k, m_max, seq, n_valid, args = _setup(name, protein, widths, pvalue, wild)
    want = _jax(mode, g, k, m_max, seq, n_valid, args)
    assert want.shape[1] > 0  # not vacuous
    multi_kernel.reset_launches()
    pos, lanes, scores = _port(mode, g, k, m_max, seq, n_valid, args)
    assert pos.tolist() == want[0].tolist()
    assert lanes.tolist() == want[1].tolist()
    assert bits(scores.numpy()).tolist() == want[2].view(np.uint32).tolist()
    assert set(multi_kernel.LAUNCHES.values()) == {0}  # plain versions on the CPU


@pytest.mark.parametrize("name,protein,widths,pvalue,wild", CASES, ids=IDS)
def test_modes_keep_the_same_hits_without_wildcards(name, protein, widths, pvalue, wild):
    g, k, m_max, seq, n_valid, args = _setup(name, protein, widths, pvalue, wild)
    hits = {mode: _triples(*_port(mode, g, k, m_max, seq, n_valid, args))
            for mode in MODES}
    assert hits["k3"] and hits["k3"] == hits["k5"]
    if not wild:
        assert hits["k4"] == hits["k3"]
    # the port's own scanner groups (K3, u16 phase C at t3) keep them too
    group = multi.group_to_device(multi.pack_motif_group(
        np.arange(g["count"]), g["count"], m_max, g["pssm"], g["th"], k), "cpu")
    counts, packed = multi.scan_multi_core(torch.from_numpy(seq), torch.from_numpy(n_valid),
                                           group, k, TILE)
    own = packed[:, : counts[2]]
    assert _triples(own[0], own[1], own[2].view(torch.float32)) == hits["k3"]


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name,protein,widths,pvalue,wild", CASES, ids=IDS)
def test_phase_c_pairs_contain_the_kept_hits(name, protein, widths, pvalue, wild, mode):
    g, k, m_max, seq, n_valid, args = _setup(name, protein, widths, pvalue, wild)
    group = multi.group_from_filters(g["pssm"], g["th"], m_max, k, "cpu",
                                     **_mode_args(mode, args))
    assert mode in group and not (set(multi.PREFILTERS) - {mode}) & set(group)
    chunk = torch.from_numpy(seq)
    maxv = getattr(multi_kernel, multi.PREFILTERS[mode])(chunk, *group[mode])
    cand = torch.nonzero(maxv >= 0).flatten()
    planes, _, t_c = group["phase_c"]
    mask = ((multi.phase_c(chunk, cand, planes, t_c) >= 0)
            & (cand[:, None] < torch.from_numpy(n_valid)))
    rows, lanes = torch.nonzero(mask, as_tuple=True)
    pairs = set(zip(cand[rows].tolist(), lanes.tolist()))
    kept = _port(mode, g, k, m_max, seq, n_valid, args)
    assert kept[0].numel() and set(zip(kept[0].tolist(), kept[1].tolist())) <= pairs


def test_k4_mode_phase_c_is_the_u8_test():
    g, k, m_max, seq, n_valid, args = _setup(*CASES[0])
    group = multi.group_from_filters(g["pssm"], g["th"], m_max, k, "cpu",
                                     filters_t=args["filters_t"])
    planes, _, t_c = group["phase_c"]
    assert planes.shape[0] == 1 and planes.shape[1] * 16 == g["f_hi"].shape[1]  # u8 cells
    positions = torch.arange(0, TILE - m_max + 1, 13)
    part = multi.phase_c(torch.from_numpy(seq), positions, planes, t_c)
    # the u8 cells and thresholds, read back from the slot layout
    cells, t4 = multi._cells_k4(args["filters_t"], k)
    cells = cells.astype(np.int64)[:, :m_max]
    p = positions.numpy()
    want = sum(cells[:, j, seq[p + j]].T for j in range(m_max)) - t4
    assert part.dtype == torch.int32 and np.array_equal(part.numpy(), want)
    # the maximum over lanes is K4's value at each position
    maxv = multi_kernel.prefilter_any(torch.from_numpy(seq), *group["k4"])
    assert np.array_equal(want.max(axis=1), maxv.numpy()[p])


def test_group_from_filters_needs_a_filter():
    g, k, m_max, _, _, _ = _setup(*CASES[0])
    with pytest.raises(ValueError, match="no prefilter"):
        multi.group_from_filters(g["pssm"], g["th"], m_max, k, "cpu")


def test_group_from_filters_refuses_i8_without_a_phase_c_filter():
    # the JAX phase C reads filters_fine or filters_t; i8 alone has none
    g, k, m_max, _, _, args = _setup(*CASES[0])
    with pytest.raises(ValueError, match="phase C"):
        multi.group_from_filters(g["pssm"], g["th"], m_max, k, "cpu",
                                 filters_i8=args["filters_i8"], widths=args["widths"])


def test_pack_filters_u8_is_the_jax_filters_t():
    # one group of every motif: the JAX pack_filters_any of the stack
    g, k, _, _, _, args = _setup(*CASES[2])
    got = multi.pack_filters_u8(g, np.arange(g["count"]), *args["discrete"], k)
    assert got.dtype == np.float32 and got.tobytes() == args["filters_t"].tobytes()


def _database(rng, n: int):
    """A small DNA database on both strands, the port's matrices and
    thresholds at p = 1e-3, and a wildcard-free sequence."""
    from lightmotif_tpu_torch import convert

    motifs = random_motifs(rng, rng.integers(5, 21, n))
    ths = [p.score_distribution().score(1e-3) for p in motifs]
    pssms, ths = convert.motif_set(motifs, ths, both_strands=True)
    ths[3] = 1e6  # unreachable: routed out
    seq = rng.integers(0, 4, 40_000).astype(np.uint8)
    return pssms, ths, seq


@pytest.mark.parametrize("mode", MODES)
def test_database_groups_scan_like_the_multiscanner_in_each_mode(mode, monkeypatch):
    from lightmotif_tpu_torch import EncodedSequence
    from lightmotif_tpu_torch.scanner import MultiScanner

    pssms, ths, seq = _database(np.random.default_rng(42), 20)
    monkeypatch.setattr(MultiScanner, "GROUP_MOTIFS", 16)  # 3 groups
    want = multi_triples(MultiScanner(pssms, thresholds=ths, device="cpu")
                         .scan_arrays(EncodedSequence(seq)))
    k = 5
    stack, lengths = multi.stack_motifs([p.data for p in pssms], k)
    short, dense = multi.route_motifs(stack, lengths, ths, k, 128)
    assert dense.size == 0 and 3 not in short.tolist()
    assert np.all(np.diff(lengths[short]) >= 0)
    dms = [p.to_discrete() for p in pssms]
    discrete = (multi.stack_motifs([d.data.astype(np.float32) for d in dms], k)[0],
                np.asarray([d.scale(t) for d, t in zip(dms, ths)]))
    groups = multi.database_groups(stack, lengths, ths, short, k, "cpu", 16,
                                   prefilter=mode, discrete=discrete)
    assert len(groups) == 3 and all(mode in g for g in groups)
    # phase C's u16 cells in two byte planes, its u8 cells in one
    assert all(g["phase_c"][0].shape[0] == (1 if mode == "k4" else 2) for g in groups)
    assert sorted(np.concatenate([g["ids"] for g in groups]).tolist()) == sorted(short.tolist())
    for segment in (len(seq), 9_000):
        got = multi_triples(multi.sorted_hits(multi.scan_groups(
            torch.from_numpy(seq), len(seq), lengths, groups, k, segment)))
        assert got and got == want  # no wildcard: every mode keeps the same hits


def test_database_groups_refuse_unknown_modes_and_a_u8_mode_without_matrices():
    pssms, ths, _ = _database(np.random.default_rng(5), 4)
    stack, lengths = multi.stack_motifs([p.data for p in pssms], 5)
    ids = np.arange(len(pssms))
    with pytest.raises(ValueError, match="unknown prefilter"):
        multi.database_groups(stack, lengths, ths, ids, 5, "cpu", 16, prefilter="u8")
    with pytest.raises(ValueError, match="discrete"):
        multi.database_groups(stack, lengths, ths, ids, 5, "cpu", 16, prefilter="k4")
    assert multi.sorted_hits([])[0].dtype == np.int32
