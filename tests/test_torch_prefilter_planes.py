"""The byte planes of the port's tensor-core prefilter, checked on the CPU.

The CUDA kernel (``lightmotif_tpu_torch/ops/csrc/prefilter.cu``) computes
K3, K4 and K5 as ``max_mo (sum_q 256**q (X @ B_q)[p, mo] - t_eff')``: the
one-hot window matrix ``X[p, j * K + s] = (s[p + j] == s)`` times the
unsigned byte planes ``B_q`` that the packers build (each (lane, row)
shifted by its minimum, the shifts folded into ``t_eff'``).  Here that
arithmetic is written out in int64 numpy for the planes the port packs,
and held bit for bit to the lookup form ``sum_j cell[mo, j, s[p + j]] -
t_eff`` of the unshifted cells, to the plain versions the wrappers run on
the CPU, and to the JAX package's Pallas kernels in interpret mode, on
every window ``p < Lp - m + 1``: K3, K5 and K4 filters packed by the JAX
package, filters written by hand with negative cells and cells past 255
(1 to 4 planes), DNA and protein, never-pass and padded lanes, wildcard
runs.  The packing reads nothing back from a device, the probes' plain
versions (P7, P8, P10) compute the same functions, and P6 equals the JAX
probe's int8 and bf16 kernels in interpret mode.
"""

import math
import re
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightmotif_tpu.ops import multi as jmulti
from lightmotif_tpu.ops import multi_kernel as jmk
from lightmotif_tpu_torch.ops import multi, multi_kernel, torch_ops
from lightmotif_tpu_torch.probes import prefilter as probes

from .torch_parity import (  # noqa: F401  (interpret_mode is an autouse fixture)
    interpret_mode, motif_stack, random_motifs, random_ranks)

#: Positions of a sequence: one Pallas tile.
LP = 4096


def plane_form(seq, planes, t_eff) -> np.ndarray:
    """The kernel's arithmetic in int64: one-hot windows times each byte
    plane, the planes combined from the top byte down, ``- t_eff``, the max
    over the lanes.  Windows past the end read the wildcard."""
    n_planes, chunks, lanes, rows, k = planes.shape
    lp = seq.size
    ext = np.concatenate([np.minimum(seq, k - 1), np.full(rows - 1, k - 1)]).astype(np.int64)
    x = np.zeros((lp, rows * k), np.int64)
    idx = np.arange(lp)[:, None] + np.arange(rows)
    x[np.arange(lp)[:, None], np.arange(rows) * k + ext[idx]] = 1
    b = planes.reshape(n_planes, chunks * lanes, rows * k).astype(np.int64)
    acc = np.zeros((lp, chunks * lanes), np.int64)
    for q in reversed(range(n_planes)):
        acc = acc * 256 + x @ b[q].T
    return (acc - np.asarray(t_eff, np.int64)).max(axis=1)


def lookup_form(seq, cells, t) -> np.ndarray:
    """``max_mo (sum_j cells[mo, j, s[p + j]] - t[mo])`` of unshifted cells
    ``[M, m, K]``, in int64."""
    m_pad, m, k = cells.shape
    ext = np.concatenate([np.minimum(seq, k - 1), np.full(m - 1, k - 1)]).astype(np.int64)
    acc = sum(cells[:, j, ext[j:j + seq.size]] for j in range(m)).astype(np.int64)
    return (acc - np.asarray(t, np.int64)[:, None]).max(axis=0)


def check(seq, name, packed, want, n):
    """The packed filters through the plane form, the plain version and the
    CPU wrapper, each equal to ``want`` on the first ``n`` windows; a device
    group's fourth and fifth items, the planes' blocks for the warpgroup
    kernel and their k-steps, are theirs."""
    planes, chunk_m, t_eff = packed[:3]
    if len(packed) == 5:
        assert np.array_equal(packed[3], multi_kernel.gmma_blocks(planes, chunk_m))
        assert packed[4] == tuple(multi_kernel.tile_ksteps(chunk_m, planes.shape[-1]).tolist())
    got = plane_form(seq, planes, t_eff)
    assert np.array_equal(got[:n], want[:n])
    tensors = [torch.from_numpy(np.ascontiguousarray(a)) for a in packed[:4]] + list(packed[4:])
    for fn in (getattr(torch_ops, name), getattr(multi_kernel, name)):
        out = fn(torch.from_numpy(seq), *tensors).numpy()
        assert np.array_equal(out[:n], want[:n])
    assert (want[:n] >= 0).any() and (want[:n] < 0).any()  # not vacuous


# -- filters the JAX package packs ---------------------------------------------

#: (name, mode, protein, motif widths, never-pass lanes); lane counts that
#: are not multiples of 16 leave padded lanes
JAX_CASES = [
    ("k3_dna", "k3", False, [5, 8, 9, 11, 12, 14, 15, 15, 17, 20, 25], 2),
    ("k3_protein", "k3", True, [5, 7, 8, 10, 12, 20, 27, 32], 1),
    ("k5_dna_ragged", "k5", False, None, 3),
    ("k5_protein", "k5", True, [5, 9, 12, 16, 21], 1),
    ("k4_dna", "k4", False, [2, 5, 9, 12, 15, 15, 15, 33, 39], 2),
    ("k4_protein", "k4", True, [4, 6, 8, 11, 14], 1),
]


def _jax_case(name, mode, protein, widths, never):
    rng = np.random.default_rng(sum(map(ord, name)))
    if widths is None:  # 250 ragged lanes: 2 contraction blocks of widths
        widths = sorted([int(w) for w in rng.integers(6, 16, size=244)]
                        + [int(w) for w in rng.integers(16, 18, size=6)])
    motifs = random_motifs(rng, widths, protein=protein)
    stack, lengths = motif_stack(motifs)
    k = stack.shape[2]
    ths = np.asarray([p.score_distribution().score(max(0.02, 2 * 4.0 ** -len(p)))
                      for p in motifs], np.float32)
    ths[:never] = 1e6
    m_max = int(lengths.max())
    g = jmulti.pack_motif_group(np.arange(len(motifs)), len(motifs), m_max, stack, ths, k)
    seq = random_ranks(rng, LP, k, wildcard_runs=12)
    return motifs, stack, lengths, ths, k, m_max, g, seq


@pytest.mark.parametrize("name,mode,protein,widths,never", JAX_CASES,
                         ids=[c[0] for c in JAX_CASES])
def test_planes_of_jax_filters_give_the_jax_values(name, mode, protein, widths, never):
    motifs, stack, lengths, ths, k, m_max, g, seq = _jax_case(name, mode, protein, widths, never)
    s8 = jnp.asarray(seq.astype(np.int8))
    if mode == "k3":
        want = jmk.prefilter_any8(s8, jnp.asarray(g["f_hi8"]), jnp.asarray(g["f_lo8"]),
                                  jnp.asarray(g["adj"]), m_max, k, tile=LP, widths=g["widths"])
        cells, t = multi._cells_i8(g["f_hi8"], g["f_lo8"], g["adj"], k, g["widths"])
        group = multi.group_from_filters(g["pssm"], g["th"], m_max, k, "cpu",
                                         filters_fine=(g["f_hi"], g["f_lo"]),
                                         filters_i8=(g["f_hi8"], g["f_lo8"], g["adj"]),
                                         widths=g["widths"])
        name_fn = "prefilter_any8"
    elif mode == "k5":
        want = jmk.prefilter_any16(s8, jnp.asarray(g["f_hi"]), jnp.asarray(g["f_lo"]),
                                   m_max, k, tile=LP, widths=g["widths"])
        cells, t = multi._cells_fine(g["f_hi"], g["f_lo"], k, g["widths"])
        group = multi.group_from_filters(g["pssm"], g["th"], m_max, k, "cpu",
                                         filters_fine=(g["f_hi"], g["f_lo"]),
                                         widths=g["widths"])
        name_fn = "prefilter_any16"
    else:
        dms = [type(p)(p.alphabet, stack[i, : lengths[i]]).to_discrete()
               for i, p in enumerate(motifs)]
        dm_stack, _ = jmulti.stack_motifs([d.data.astype(np.float32) for d in dms], k)
        t_scaled = np.asarray([d.scale(t) for d, t in zip(dms, ths)], np.int64)
        t_scaled[:never] = 300
        filters_t = multi_kernel.pack_filters_any(dm_stack, t_scaled, k)
        want = jmk.prefilter_any(s8, jnp.asarray(filters_t), m_max, k, tile=LP)
        cells, t = multi._cells_k4(filters_t, k)
        group = multi.group_from_filters(g["pssm"], g["th"], m_max, k, "cpu",
                                         filters_t=filters_t)
        name_fn = "prefilter_any"
    want = np.asarray(want).reshape(-1)
    n = LP - m_max + 1
    assert np.array_equal(lookup_form(seq, cells, t)[:n], want[:n])
    packed = (*(a.numpy() for a in group[mode][:4]), group[mode][4])
    assert packed[0].shape[0] == (1 if mode == "k4" else 2)  # u8: one plane, u16: two
    check(seq, name_fn, packed, want, n)
    if mode != "k4":  # the packer's own planes of the same u16 cells
        d16, f16, off16 = multi.fine_discretize(g["pssm"])
        t16 = np.where(multi.unreachable_thresholds(g["pssm"], g["th"]), 65536,
                       multi.fine_thresholds(g["th"], f16, off16))
        own = (multi.pack_filters_k3 if mode == "k3" else multi.pack_filters_k5)(d16, t16)
        check(seq, name_fn, own, want, n)
        never_t = multi.K3_NEVER if mode == "k3" else multi.K5_NEVER
        assert (own[2][:never] == never_t).all() and (own[2][len(motifs):] == never_t).all()


# -- filters written by hand ------------------------------------------------------


def _hand_cells(rng, n_planes, m, k, count):
    """Integer cells ``[count, m, K]`` that bf16 holds exactly, with
    negative values and values past 255, whose shifted range needs
    ``n_planes`` byte planes; window sums stay below ``2**24``."""
    if n_planes == 1:  # rows far from 0 and close together: the shift takes the offset
        cells = (rng.integers(-25, 26, size=(count, m, k)) * 4
                 + rng.choice([-512, 0, 512], size=(count, m, 1)))
    elif n_planes == 2:
        cells = rng.integers(-75, 151, size=(count, m, k)) * 4
    elif n_planes == 3:
        cells = rng.integers(-128, 129, size=(count, m, k)) * 512
    else:  # one row spans 2**24 after its shift
        cells = rng.integers(-100, 101, size=(count, m, k))
        cells[:, 1] = 0
        cells[:, 1, 0] = 1 << 23
        cells[:, 1, 1] = -(1 << 23)
    return cells.astype(np.int64)


def _thresholds(rng, seq, cells):
    """Per-lane thresholds near the top of each lane's window sums, so some
    windows pass and most do not."""
    m = cells.shape[1]
    k = cells.shape[2]
    ext = np.concatenate([np.minimum(seq, k - 1), np.full(m - 1, k - 1)])
    sums = sum(cells[:, j, ext[j:j + seq.size]] for j in range(m))
    return np.quantile(sums, 0.995, axis=1).astype(np.int64) + rng.integers(0, 3, cells.shape[0])


#: (mode, protein, planes, motif rows, lanes)
HAND_CASES = [
    ("k4", False, 1, 9, 21), ("k4", False, 2, 15, 37), ("k4", False, 3, 6, 16),
    ("k4", False, 4, 5, 18), ("k4", True, 1, 7, 19), ("k4", True, 3, 4, 9),
    ("k5", False, 2, 8, 23), ("k5", False, 3, 6, 17), ("k5", True, 2, 5, 11),
]


@pytest.mark.parametrize("mode,protein,n_planes,m,count", HAND_CASES,
                         ids=[f"{c[0]}_{'protein' if c[1] else 'dna'}_{c[2]}planes"
                              for c in HAND_CASES])
def test_hand_written_filters_pick_their_planes_and_keep_every_value(
        mode, protein, n_planes, m, count):
    rng = np.random.default_rng(100 * n_planes + m + count)
    k = 21 if protein else 5
    lanes = multi_kernel._lanes_for(k)
    seq = random_ranks(rng, LP, k, wildcard_runs=10)
    s8 = jnp.asarray(seq.astype(np.int8))
    n = LP - m + 1
    if mode == "k4":
        cells = _hand_cells(rng, n_planes, m, k, count)
        # the window sums must stay below 2**24 with the threshold: the
        # 4-plane cells span 2**24 by themselves, so their thresholds are small
        t = _thresholds(rng, seq, cells) if n_planes < 4 else rng.integers(0, 100, count)
        t[0] = 1 << 16  # a never-pass lane, as the JAX NEG_GUARD writes it
        filters_t = multi_kernel.pack_slots(cells.astype(np.float32), k)
        filters_t[lanes - 1, :count] = -t
        filters_t[lanes - 1, count:] = -multi_kernel.NEG_GUARD  # padded lanes
        want = np.asarray(jmk.prefilter_any(s8, jnp.asarray(filters_t), m, k, tile=LP)).reshape(-1)
        packed = multi.pack_filters_k4(filters_t, k)
        name = "prefilter_any"
    else:
        # u16-style cells 256 * hi + lo from hand-written hi and lo planes,
        # lo negative or past 255
        hi = rng.integers(0, 100, size=(count, m, k))
        if n_planes == 3:
            hi = rng.integers(-128, 129, size=(count, m, k)) * 16
        lo = rng.integers(-75, 151, size=(count, m, k)) * 4
        cells = 256 * hi + lo
        t = _thresholds(rng, seq, cells)
        f_hi = multi_kernel.pack_slots(hi.astype(np.float32), k)
        f_lo = multi_kernel.pack_slots(lo.astype(np.float32), k)
        f_hi[lanes - 1, :count] = -(t >> 8)
        f_lo[lanes - 1, :count] = -(t & 255)
        f_hi[lanes - 1, count:] = -1024.0  # padded lanes never pass
        want = np.asarray(jmk.prefilter_any16(s8, jnp.asarray(f_hi), jnp.asarray(f_lo),
                                              m, k, tile=LP)).reshape(-1)
        zeros = np.zeros((f_hi.shape[1], m, k), np.float32)
        dev = multi.group_from_filters(zeros, np.zeros(f_hi.shape[1], np.float32), m, k,
                                       "cpu", filters_fine=(f_hi, f_lo))["k5"]
        packed = (*(a.numpy() for a in dev[:4]), dev[4])
        name = "prefilter_any16"
    assert (cells < 0).any() and (np.abs(cells) > 255).any()
    planes, chunk_m, t_eff = packed[:3]
    assert planes.dtype == np.uint8 and planes.shape[0] == n_planes
    assert planes.shape[3] * k % multi_kernel.ROW_BYTES == 0
    check(seq, name, packed, want, n)


def test_planes_past_the_kernel_range_are_refused():
    # shifted cells past 4 bytes, or thresholds past int32, have no planes
    cells = np.zeros((16, 2, 5), np.int64)
    cells[0, 0, 0] = 1 << 33
    with pytest.raises(ValueError, match="range"):
        multi._plane_table(cells, np.zeros(16))
    with pytest.raises(ValueError, match="range"):
        multi._plane_table(np.zeros((16, 2, 5)), np.full(16, 1 << 40))
    # four planes' worth in each of 129 rows: the window sums leave int32
    with pytest.raises(ValueError, match="range"):
        multi._plane_table(np.full((16, 129, 5), 1 << 24) * np.arange(5), np.zeros(16))
    # 128 rows of the largest 3-plane cells still fit
    planes = multi._plane_table(np.full((16, 128, 5), (1 << 24) - 1) * (np.arange(5) > 0),
                                np.zeros(16))[0]
    assert planes.shape[0] == 3


# -- no device read -------------------------------------------------------------


@pytest.mark.parametrize("prefilter", ["k3", "k5", "k4"])
def test_packing_reads_nothing_back_from_the_device(prefilter):
    # a tensor on the meta device has a shape and no data: packing that read
    # a device value back would fail here; the planes' count and bytes are
    # fixed on the host, and the launch geometry comes from the shapes alone
    motifs, stack, lengths, ths, k, m_max, g, seq = _jax_case(
        "meta", "k3", False, [5, 9, 12, 15, 15, 22, 30], 1)
    dms = [type(p)(p.alphabet, stack[i, : lengths[i]]).to_discrete() for i, p in enumerate(motifs)]
    discrete = (jmulti.stack_motifs([d.data.astype(np.float32) for d in dms], k)[0],
                np.asarray([d.scale(t) for d, t in zip(dms, ths)], np.int64))
    ids = np.argsort(lengths, kind="stable")
    groups = multi.database_groups(stack, lengths, ths, ids, k, torch.device("meta"), 4,
                                   prefilter=prefilter, discrete=discrete)
    assert len(groups) == 2
    for group in groups:
        planes, chunk_m, t_eff, blocks, ksteps = group[prefilter]
        assert planes.is_meta and chunk_m.is_meta and t_eff.is_meta and blocks.is_meta
        assert blocks.dtype == torch.uint8 and tuple(blocks.shape[1:]) == (
            multi_kernel.GMMA_LANES, multi_kernel.GMMA_KSTEP)
        assert blocks.shape[0] == planes.shape[0] * sum(ksteps)
        assert planes.dtype == torch.uint8 and 1 <= planes.shape[0] <= multi_kernel.MAX_PLANES
        assert planes.shape[2] == multi_kernel.K3_LANES and planes.shape[4] == k


# -- the probes' plain versions ---------------------------------------------------


#: P6's CPU shape: lanes and positions cut from the JAX probe's 2,048 and
#: 1,024 (its kernel bodies take any); the depth stays its 3 x 128.
P6_LANES, P6_TILE = 256, 256


def int8_probe():
    """``experiments/int8_probe.py``, imported from this checkout.  The
    module puts a fixed directory at the front of ``sys.path`` and imports
    ``tools.perf`` through it, so ``tools.perf`` is imported first from the
    checkout and ``sys.path`` is put back right after: neither ``tools`` nor
    any later import resolves through that directory."""
    import tools.perf

    assert Path(tools.perf.__file__).resolve().parents[1] == Path(__file__).resolve().parents[1]
    saved = list(sys.path)
    try:
        from experiments import int8_probe as module
    finally:
        sys.path[:] = saved
    return module


def p6_draw(case: str, seed: int = 6):
    """The JAX probe's operands, float32 ``[depth, lanes]`` and ``[depth,
    tile]``: its own draw (``experiments/int8_probe.py::main``: filters
    from ``integers(-100, 100)``, windows from {0, 1}), or the s8 extremes:
    cells -128 (nine in ten) and 127, lane 0 all -128, all-ones windows,
    so every sum is at most ``384 * 127`` and every maximum negative."""
    depth = int8_probe().BLOCKS * 128
    rng = np.random.default_rng(seed)
    if case == "draw":
        return (rng.integers(-100, 100, (depth, P6_LANES)).astype(np.float32),
                rng.integers(0, 2, (depth, P6_TILE)).astype(np.float32))
    fb = np.where(rng.random((depth, P6_LANES)) < 0.9, -128, 127).astype(np.float32)
    fb[:, 0] = -128
    return fb, np.ones((depth, P6_TILE), np.float32)


def jax_p6(kind: str, fb: np.ndarray, xb: np.ndarray) -> np.ndarray:
    """The JAX probe's kernel of ``kind`` (``_kernel_int8`` on the int8
    operands, ``_kernel_bf16`` on the float32 ones, as its ``main`` calls
    them) in interpret mode: int32 ``[tile]``."""
    import jax
    from jax.experimental import pallas as pl

    module = int8_probe()
    body = module._kernel_int8 if kind == "int8" else module._kernel_bf16
    f, x = (fb.astype(np.int8), xb.astype(np.int8)) if kind == "int8" else (fb, xb)
    out = pl.pallas_call(body, out_shape=jax.ShapeDtypeStruct((1, x.shape[1]), jnp.int32),
                         interpret=True)(f, x)
    return np.asarray(out)[0]


@pytest.mark.parametrize("case", ["draw", "extremes"])
@pytest.mark.parametrize("kind", ["int8", "bf16"])
def test_p6_plain_version_is_the_exact_integer_product(kind, case):
    # the port's P6 (the wrapper on CPU tensors, K-major: the JAX operands
    # transposed) bit for bit to the JAX probe's kernels at depth 3 x 128
    fb, xb = p6_draw(case)
    want = jax_p6(kind, fb, xb)
    filt = torch.from_numpy(np.ascontiguousarray(fb.T.astype(np.int8)))
    x = torch.from_numpy(np.ascontiguousarray(xb.T.astype(np.int8)))
    got = probes.mma_max(*probes.mma_operands(filt, x, kind), kind).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)
    exact = (xb.T.astype(np.int64) @ fb.astype(np.int64)).max(axis=1)
    assert np.array_equal(got, exact)
    if case == "extremes":
        assert got.max() < 0 and np.abs(xb.T @ fb).max() == 384 * 128


def test_p6_inputs_are_the_jax_probes_draw():
    # mma_inputs is experiments/int8_probe.py::main's draw at a tile of
    # n_pos positions, transposed to the port's K-major layout
    filt, x = probes.mma_inputs(40, seed=0)
    rng = np.random.default_rng(0)
    fb = rng.integers(-100, 100, (3 * 128, 2048)).astype(np.float32)
    xb = rng.integers(0, 2, (3 * 128, 40)).astype(np.float32)
    assert filt.dtype == x.dtype == np.int8 and filt.flags.c_contiguous and x.flags.c_contiguous
    assert np.array_equal(filt, fb.T.astype(np.int8)) and np.array_equal(x, xb.T.astype(np.int8))
    one, _ = probes.mma_inputs(40, seed=0, blocks=1)
    assert one.shape == (2048, 128) and one.min() < 0


def test_p6_wrapper_refuses_other_inputs():
    filt, x = (torch.from_numpy(a) for a in probes.mma_inputs(20, seed=1, blocks=1))
    with pytest.raises(ValueError):
        probes.mma_max(filt, x, "f32")
    with pytest.raises(ValueError):
        probes.mma_operands(filt, x, "u8")
    bad = [(filt.view(torch.uint8), x.view(torch.uint8), "int8"),  # the earlier unsigned cells
           (filt, x, "bf16"),  # int8 operands for the bf16 form
           (filt.to(torch.bfloat16), x, "bf16"),
           (filt[:0], x, "int8"),  # no lane
           (filt[:, :64], x[:, :64], "int8"),  # not whole blocks
           (filt.repeat(1, 2), x.repeat(1, 2), "int8"),  # two blocks
           (filt.repeat(1, 4), x.repeat(1, 4), "int8"),  # four blocks
           (filt, x[:, :64], "int8"),
           (filt, x[0], "int8")]
    for f, xx, kind in bad:
        with pytest.raises(TypeError):
            probes.mma_max(f, xx, kind)
    assert probes.mma_max(filt, x[:0], "int8").shape == (0,)


def test_p7_lookup_table_and_baseline_compute_the_prefilter():
    motifs, stack, lengths, ths, k, m_max, g, seq = _jax_case(
        "p7", "k3", False, [5, 8, 12, 16, 16, 23], 1)
    planes, chunk_m, t_eff = (torch.from_numpy(a) for a in multi.pack_motif_group(
        np.arange(g["count"]), g["count"], m_max, g["pssm"], g["th"], k)["k3"])
    table = probes.lookup_table(planes)
    chunks, rows, kk, lanes = table.shape
    assert table.dtype == torch.int32 and (kk, lanes) == (k, multi_kernel.K3_LANES)
    cells = torch_ops.plane_cells(planes)
    assert torch.equal(table.permute(0, 3, 1, 2).reshape(chunks * lanes, rows, k), cells)
    s = torch.from_numpy(seq)
    probes.reset_launches()
    got = probes.prefilter_lookup(s, table, chunk_m, t_eff)
    assert torch.equal(got, torch_ops.prefilter_any8(s, planes, chunk_m, t_eff))
    assert set(probes.LAUNCHES.values()) == {0}  # the CPU runs no kernel


def test_p8_p10_variants_run_the_plain_version_on_the_cpu():
    rng = np.random.default_rng(8)
    cells = rng.integers(0, 40_000, size=(48, 16, 5))
    packed = [torch.from_numpy(a) for a in multi._plane_table(cells, rng.integers(0, 400_000, 48))]
    s = torch.from_numpy(random_ranks(rng, 3000, 5, wildcard_runs=4))
    want = torch_ops.prefilter_any8(s, *packed)
    for v in range(len(probes.VARIANTS)):
        assert torch.equal(probes.prefilter_variant(v, s, *packed), want)
    with pytest.raises(ValueError):
        probes.prefilter_variant(len(probes.VARIANTS), s, *packed)


def test_variant_table_is_the_sources():
    # the probe module's mirror of LM_VARIANTS in csrc/prefilter.cu, checked
    # without a compiler
    src = (Path(multi_kernel.__file__).parent / "csrc" / "prefilter.cu").read_text()
    rows = re.findall(r"X\((true|false), (\d+), (\d+), (\d+)\)", src)
    table = [("m" if pm == "true" else "n", int(cpp), int(pw), int(w))
             for pm, cpp, pw, w in rows]
    assert table == probes.VARIANTS
    production = int(re.search(r"constexpr int PRODUCTION = (\d+);", src).group(1))
    assert 0 <= production < len(table)
    # every instantiation keeps whole 16-position tiles per warp
    assert all(pw % 16 == 0 and math.log2(w).is_integer() for _, _, pw, w in table)
