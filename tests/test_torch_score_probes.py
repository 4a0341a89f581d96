"""The scoring probes (``lightmotif_tpu_torch.probes.scoring``) and P9 on the
CPU: each wrapper's plain version against the JAX package's reference or
a numpy restatement of the JAX probe body it answers, and the probe
tables against the CUDA sources they mirror (checked without a
compiler).  The kernels themselves run in ``tests/test_torch_cuda.py``.
"""

import functools
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lightmotif_tpu.ops import xla_ops
from lightmotif_tpu_torch.ops import multi
from lightmotif_tpu_torch.probes import prefilter as pprobes
from lightmotif_tpu_torch.probes import scoring

from .torch_parity import bits, pssms, random_counts, random_ranks, sequences

CSRC = Path(scoring.__file__).resolve().parent.parent / "ops" / "csrc"

#: (K, m, protein): DNA m = 15 and m = 130, protein K = 21
CASES = [(5, 15, False), (5, 130, False), (21, 10, True)]
LENGTH = 5003  # a multiple of no block size
NS_SHORT = 37  # n_scores this many windows short of the last


@functools.lru_cache(maxsize=None)
def case_inputs(k: int, m: int, protein: bool):
    """The sequence with wildcard runs (clamped) and the same with ranks
    >= K scattered in (raw), the f32 and u8 tables, n_scores, and the JAX
    package's f32 scores (``ScoringMatrix.score_host``) and discrete
    scores (``xla_ops.score_u8``) of the clamped sequence."""
    rng = np.random.default_rng(1000 * k + m)
    jpssm, tpssm = pssms(random_counts(rng, m, k), protein)
    clamped = random_ranks(rng, LENGTH, k, wildcard_runs=6)
    raw = clamped.copy()
    spots = rng.choice(LENGTH, 40, replace=False)
    raw[spots] = rng.integers(k, 256, 40)
    clamped[spots] = k - 1
    jseq, _ = sequences(clamped, protein)
    host = jpssm.score_host(jseq)
    dm = jpssm.to_discrete().data
    n = LENGTH - m + 1 - NS_SHORT
    disc = np.asarray(jax.jit(xla_ops.score_u8, static_argnums=2)(clamped.astype(np.int8), dm, n))
    return raw, np.asarray(tpssm.data, np.float32), dm, n, host, disc


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"k{c[0]}m{c[1]}")
@pytest.mark.parametrize("variant", range(len(scoring.VARIANTS)))
def test_variant_plain_is_the_reference(variant, case):
    k, m, protein = case
    raw, w, dm, n, host, disc = case_inputs(*case)
    seq = torch.from_numpy(raw)
    for table, discrete in ((w, False), (dm, True)):
        t = torch.from_numpy(table)
        if not scoring.accepts(variant, discrete, m, k):
            with pytest.raises(ValueError):
                scoring.score_variant(variant, seq, t, n)
            continue
        got = scoring.score_variant(variant, seq, t, n).numpy()
        assert got.shape == (LENGTH,)
        if discrete:
            assert got.dtype == np.int32
            assert np.array_equal(got[:n], disc[:n])
            assert np.all(got[n:] == -1)
        else:
            assert np.array_equal(bits(got[:n]), bits(host[:n]))
            assert np.all(np.isneginf(got[n:]))


# -- family B ---------------------------------------------------------------


def _window(raw: np.ndarray, m: int, k: int) -> np.ndarray:
    """The kernel's ranks: clamped to the wildcard, which is also read
    past the end."""
    return np.concatenate([np.minimum(raw, k - 1), np.full(m - 1, k - 1, np.uint8)]).astype(
        np.int64)


def diag_numpy(mode, raw, t, n):
    """The JAX probe bodies in numpy (f32 arithmetic, one rounding per op):
    ``f32_probe3._io_kernel``, ``f32_probe._floor_kernel``,
    ``perf_variants2._kernel`` (diag_nosel, diag_noroll),
    ``perf_variants8._addsplit_kernel`` and ``f32_probe3._u8o_kernel``,
    a lane roll by ``width - j`` read as the window ``j`` positions on."""
    m, k = t.shape
    lp = raw.shape[0]
    if mode == "io":
        return raw.astype(np.float32) + t[0, 0]
    win = _window(raw, m, k)
    wf = win.astype(np.float32)
    if mode == "floor":
        acc = wf[:lp] * t[0, 0]
        for j in range(1, m):
            acc = acc + wf[j:j + lp] * t[j, 0]
    elif mode == "nosel":
        acc = wf[:lp].copy()
        for j in range(1, m):
            acc = acc + wf[j:j + lp]
    elif mode == "noroll":
        acc = t[0][win[:lp]]
        for j in range(1, m):
            acc = acc + t[j][win[:lp]]
    elif mode == "add":  # accs[c] + accs[c] * 0 + x
        x = wf[:lp]
        acc = x.copy()
        for _ in range(1, m):
            acc = acc + acc * np.float32(0) + x
    else:  # u8out: the f32 table of u8 cells, min 255, 255 past the end
        tf = t.astype(np.float32)
        acc = tf[0][win[:lp]]
        for j in range(1, m):
            acc = acc + tf[j][win[j:j + lp]]
        acc = np.minimum(acc, np.float32(255))
        return np.where(np.arange(lp) < n, acc, np.float32(255)).astype(np.uint8)
    return np.where(np.arange(lp) < n, acc, np.float32(-np.inf)).astype(np.float32)


@pytest.mark.parametrize("mode", scoring.DIAG_MODES)
def test_diag_plain_restates_the_jax_body(mode):
    raw, w, dm, n, _, _ = case_inputs(5, 15, False)
    t = dm if mode == "u8out" else w
    got = scoring.score_diag(mode, torch.from_numpy(raw), torch.from_numpy(t), n).numpy()
    want = diag_numpy(mode, raw, t, n)
    assert got.dtype == want.dtype and got.shape == want.shape
    if mode == "u8out":
        assert np.array_equal(got, want)
    else:
        assert np.array_equal(bits(got), bits(want))


# -- family C ---------------------------------------------------------------


def _roll(a: np.ndarray, d: int) -> np.ndarray:
    """``pltpu.roll(a, width - d)`` over 32-lane rows: lane l takes lane
    (l + d) % 32."""
    return np.roll(a.reshape(-1, 32), -d, axis=1).reshape(-1)


def chain_numpy(op, steps, chains, x, table):
    """The JAX probe bodies in numpy, with the H100's 32-lane warp for the
    TPU's lane axis: ``f32_probe._cal_kernel`` (fadd: acc + b, acc - b;
    8 chains folded), ``op_cost_probe(2).make_kernel`` (roll, gather,
    kernelmix; the P12 gathers into one accumulator), ``pairsum_probe``'s
    skeletons (single, pair4; pair1 as pair4's sums, the 25-entry lookup
    the H100 has), ``perf_variants7._probe_kernel``'s table gather
    (``tga_i32_16``-style, ints ``3s``) and ``perf_variants6._i8_kernel``'s
    int8 ops (saturating add, compare-select, 256-entry byte gather) on
    bytes."""
    xi = x.astype(np.int64)
    col = np.arange(8, dtype=np.float32)  # the TPU's sublane index
    if op == "fadd":
        b = x.astype(np.float32)
        accs = [b + np.float32(c) for c in range(chains)]
        for _ in range(steps // 2):
            for c in range(chains):
                accs[c] = accs[c] + b
                accs[c] = accs[c] - b
        out = accs[0]
        for a in accs[1:]:
            out = out + a
        return out
    if op in ("shfl", "smem"):
        accs = [xi + c for c in range(chains)]
        for i in range(steps):
            accs = [_roll(a, 1 + i % 3) for a in accs]
        return sum(accs).astype(np.int32)
    if op in ("lds", "sel", "prmt"):
        tab = np.arange(8) * 3 if op == "prmt" else col
        idxs = [(xi + c) & 7 for c in range(chains)]
        acc = np.zeros(x.shape, np.int64 if op == "prmt" else np.float32)
        for _ in range(steps):
            for c in range(chains):
                acc = acc + tab[idxs[c]]
            idxs = [(ix + 1) & 7 for ix in idxs]
        return acc.astype(np.int32 if op == "prmt" else np.float32)
    if op == "mix":
        idx = xi & 7
        acc = col[idx]
        for i in range(steps):
            acc = acc + _roll(col[(idx + i) & 7], i + 1)
        return acc
    if op in ("skel1", "pair1", "pair4"):
        idx = xi % 5 if op == "skel1" else (xi % 5) * 5 + ((xi >> 2) % 5)
        acc = np.zeros(x.shape, np.float32)
        for _ in range(steps):
            idx = _roll(idx, 1 if op == "skel1" else 2)
            low = idx & 7
            v = col[low]
            if op != "skel1":
                for g in range(1, 4):
                    v = np.where(idx >= 8 * g, col[low] + np.float32(g), v)
            acc = acc + v
        return acc
    outs = []
    for c in range(chains):
        v = (xi + c) & 255
        for i in range(steps):
            if op == "vadd4":
                v = np.minimum(v + 1 + i % 3, 255)
            elif op == "vsel":
                v = np.where(v >= 200, 7, v + 1)
            else:
                v = table.astype(np.int64)[v]
        outs.append(v)
    return sum(outs).astype(np.int32)


@pytest.mark.parametrize("variant", range(len(scoring.CHAINS)))
def test_chain_plain_restates_the_jax_body(variant):
    op, steps, chains = scoring.CHAINS[variant]
    rng = np.random.default_rng(variant)
    x = rng.integers(0, 256, 32 * 20).astype(np.uint8)
    table = scoring.chain_table(op)
    got = scoring.op_chain(variant, torch.from_numpy(x), table).numpy()
    want = chain_numpy(op, steps, chains, x, table.numpy())
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


# -- P9 ---------------------------------------------------------------------


def bits2_numpy(flat, filters, t_scaled, n_valid, m_max, tile, guard_tile):
    """``experiments/multi_opt.py::_bits2_kernel`` in numpy: per tile, the
    window sums of the one-hot rows ``j * 8 + s`` (the halo of the last
    tile wraps to the first, as its BlockSpec does), ``scores >= t`` as
    bits, masked by ``pos < n_valid`` from ``guard_tile`` on, packed 16
    lanes per int32 word."""
    lp = flat.shape[0]
    grid = lp // tile
    lanes = filters.shape[1]
    powers = np.zeros((lanes, lanes // 16), np.int64)
    powers[np.arange(lanes), np.arange(lanes) // 16] = 1 << (np.arange(lanes) % 16)
    out = np.zeros((lp, lanes // 16), np.int32)
    for i in range(grid):
        halo = flat[((i + 1) % grid) * tile:][: m_max - 1]
        seq = np.concatenate([flat[i * tile:(i + 1) * tile], halo]).astype(np.int64)
        scores = np.zeros((tile, lanes), np.float32)
        for j in range(m_max):
            scores = scores + filters[j * 8 + seq[j:j + tile]]
        ok = scores >= t_scaled
        if i >= guard_tile:
            ok &= (np.arange(tile)[:, None] + i * tile) < n_valid
        out[i * tile:(i + 1) * tile] = ok.astype(np.int64) @ powers
    return out


def test_p9_plain_restates_bits2():
    rng = np.random.default_rng(9)
    lanes, m, k, tile, length = 32, 15, 5, 128, 1000
    lp = -(-length // tile) * tile
    flat = np.full(lp, k - 1, np.uint8)
    flat[:length] = rng.integers(0, 4, length)
    cells = rng.integers(0, 200, size=(lanes, m, k))
    cells[:, :, k - 1] = 0
    t = rng.integers(1200, 1700, lanes)
    filters = np.zeros((128, lanes), np.float32)
    for j in range(m):
        filters[j * 8:j * 8 + k] = cells[:, j, :].T
    n_valid = np.full(lanes, length - m + 1, np.int32)
    # padded lanes, as the JAX packer leaves them: no valid window and a
    # threshold no window reaches (the kernel masks only from guard_tile on)
    n_valid[-3:] = 0
    t[-3:] = 1 << 20
    guard = (length - m + 1) // tile
    want = bits2_numpy(flat, filters, t.astype(np.float32), n_valid, m, tile, guard)
    planes, chunk_m, t_eff = (torch.from_numpy(a) for a in multi._plane_table(cells, t))
    got = pprobes.prefilter_bits(torch.from_numpy(flat), planes, chunk_m, t_eff,
                                 torch.from_numpy(n_valid)).numpy()
    assert got.shape == want.shape and got.dtype == np.int32
    assert np.array_equal(got, want)
    assert want.any() and not (want[:, 1] >> 13).any()  # bits set; lanes 29-31 never
    # the guard: the last tile has windows past n_valid that reach t unmasked
    unmasked = bits2_numpy(flat, filters, t.astype(np.float32), n_valid, m, tile, guard + 1)
    assert not np.array_equal(unmasked, want)


# -- P13 --------------------------------------------------------------------


def test_pair_parity_is_the_jax_probes():
    from bench import ECOLI_LENGTH, PATTERNS
    from experiments.pairsum_probe import parity_host

    import lightmotif_tpu_torch as tlm

    pssm = tlm.CountMatrix.from_sequences(
        tlm.EncodedSequence.encode(p) for p in PATTERNS).to_freq(0.1).to_weight(None).to_scoring()
    genome = np.random.default_rng(0xECC011).integers(0, 4, size=ECOLI_LENGTH, dtype=np.int8)
    got = scoring.pair_parity(pssm.data, genome)
    assert got["windows"] == ECOLI_LENGTH - 15 + 1
    assert got["pairwise"] == parity_host() > 0
    assert got["prefix"] == {2: 0, 4: 0, 6: 0}


# -- the tables mirror the sources ------------------------------------------


def test_variant_table_is_the_sources():
    src = (CSRC / "score.cu").read_text()
    rows = re.findall(r"X\(LK_(\w+), (\d+), (\d+), (\d+), HALO_(\w+), (\d), (\d), (\d+), (\d+), "
                      r"(\d+)\)", src)
    table = [(lk.lower(), int(p), int(nt), int(tp), halo.lower(), int(lazy), int(persist),
              int(minb), int(kc), int(g)) for lk, p, nt, tp, halo, lazy, persist, minb, kc, g in rows]
    assert table == scoring.VARIANTS
    lookups = re.findall(r"constexpr int LK_(\w+) = (\d+);", src)
    assert [name.lower() for name, _ in sorted(lookups, key=lambda r: int(r[1]))] == \
        scoring._LOOKUPS
    halos = re.findall(r"constexpr int HALO_(\w+) = (\d+);", src)
    assert [name.lower() for name, _ in sorted(halos, key=lambda r: int(r[1]))] == scoring._HALOS
    prod = {name: int(v) for name, v in re.findall(r"constexpr int (PRODUCTION_\w+|GENERIC) = "
                                                   r"(\d+);", src)}
    # production takes the main path's DNA tables; the generic one takes all
    assert scoring.accepts(prod["PRODUCTION_F32"], False, 15, 5)
    assert scoring.accepts(prod["PRODUCTION_U8"], True, 15, 5)
    for discrete in (False, True):
        for m, k in ((1, 2), (300, 5), (40, 21), (3, 256)):
            assert scoring.accepts(prod["GENERIC"], discrete, m, k)
    # every instantiation keeps whole 32-bit words, groups and rounds
    for lk, p, nt, tp, *_, g in scoring.VARIANTS:
        assert lk == "legacy" or (g % 4 == 0 and p % g == 0 and tp % (nt * p) == 0)


def test_chain_and_diag_tables_are_the_sources():
    src = (CSRC / "probes.cu").read_text()
    block = src[src.index("#define LM_CHAIN_VARIANTS"):]
    rows = re.findall(r"X\(OP_(\w+), (\d+), (\d+)\)", block)
    assert [(op.lower(), int(r), int(c)) for op, r, c in rows] == scoring.CHAINS
    ops = re.findall(r"constexpr int OP_(\w+) = (\d+);", src)
    assert [name.lower() for name, _ in sorted(ops, key=lambda r: int(r[1]))] == scoring._OPS
    modes = re.findall(r"constexpr int DIAG_(\w+) = (\d+);", src)
    assert [name.lower() for name, _ in sorted(modes, key=lambda r: int(r[1]))] == \
        scoring.DIAG_MODES
    for probe, (_, vs) in scoring.CHAIN_PROBES.items():
        assert vs and all(0 <= v < len(scoring.CHAINS) for v in vs), probe
    for probe, (_, vs) in scoring.PROBE_VARIANTS.items():
        assert vs and all(0 <= v < len(scoring.VARIANTS) for v in vs), probe


# -- the wrappers on the CPU ------------------------------------------------


def test_probe_wrappers_launch_nothing_on_the_cpu():
    raw, w, dm, n, _, _ = case_inputs(5, 15, False)
    seq = torch.from_numpy(raw)
    scoring.reset_launches()
    pprobes.reset_launches()
    for v in range(len(scoring.VARIANTS)):
        for t in (w, dm):
            if scoring.accepts(v, t.dtype == np.uint8, 15, 5):
                scoring.score_variant(v, seq, torch.from_numpy(t), n)
    for mode in scoring.DIAG_MODES:
        scoring.score_diag(mode, seq, torch.from_numpy(dm if mode == "u8out" else w), n)
    x = torch.zeros(64, dtype=torch.uint8)
    for v in range(len(scoring.CHAINS)):
        scoring.op_chain(v, x)
    planes, chunk_m, t_eff = (torch.from_numpy(a) for a in multi._plane_table(
        np.ones((16, 3, 5), np.int64), np.full(16, 2)))
    pprobes.prefilter_bits(seq, planes, chunk_m, t_eff, torch.zeros(16, dtype=torch.int32))
    assert set(scoring.LAUNCHES.values()) == {0}
    assert set(pprobes.LAUNCHES.values()) == {0}


def test_probe_wrappers_refuse_what_they_do_not_take():
    seq = torch.zeros(100, dtype=torch.uint8)
    w = torch.zeros((3, 5), dtype=torch.float32)
    with pytest.raises(ValueError):
        scoring.score_variant(len(scoring.VARIANTS), seq, w, 10)
    with pytest.raises(ValueError):
        scoring.score_diag("nope", seq, w, 10)
    with pytest.raises(TypeError):
        scoring.op_chain(0, torch.zeros(33, dtype=torch.uint8))
    with pytest.raises(TypeError):  # the kernel would read past a short table
        scoring.op_chain(28, torch.zeros(64, dtype=torch.uint8), torch.zeros(8, dtype=torch.uint8))
    with pytest.raises((TypeError, ValueError)):  # no kernel, no plain version on meta
        scoring.score_variant(1, seq.to("meta"), w.to("meta"), 10)


def test_heads_are_the_bytes_after_each_block():
    rng = np.random.default_rng(4)
    raw = rng.integers(0, 5, 2500).astype(np.uint8)
    heads = scoring.heads_for(torch.from_numpy(raw), 15, 5, 1024).numpy()
    assert heads.shape == (3, 16)
    padded = np.concatenate([raw, np.full(3 * 1024 + 16, 4, np.uint8)])
    for b in range(3):
        assert np.array_equal(heads[b], padded[(b + 1) * 1024:(b + 1) * 1024 + 16])
