"""Multi-motif scanning: a whole motif group against a sequence at once.

Counterpart of :mod:`lightmotif_tpu.ops.multi`.  The host packers
(:func:`fine_discretize` to :func:`pack_dense_motif`) are numpy and
give the JAX package's arrays byte for byte; :func:`pack_motif_group`
adds the layouts the port's device stages read (``k3``, ``fine``,
``t_eff``), and :func:`group_from_filters` builds them from the JAX
filters of any prefilter mode.  :func:`route_motifs`,
:func:`pack_database` and :func:`database_groups` split a whole motif
database into those groups, in any mode, for :func:`scan_groups`.

The device stages (:func:`scan_multi_core`) are the torch version of
the JAX ``scan_multi_core`` on one segment:

1. the prefilter, chosen in the JAX order from the filters the group
   holds: K3 (``k3``, the JAX ``filters_i8``), else K5 (``k5``,
   ``filters_fine``), else K4 (``k4``, the u8 ``filters_t``); each gives
   ``max_mo (sum - t_eff)`` of every window start, and ``>= 0`` marks a
   candidate (:mod:`.multi_kernel` states the three formulas);
2. candidates: one ``torch.nonzero``, exact, so there are no capacities
   and no retry;
3. phase C: the test per (candidate, motif lane) inside the lane's valid
   windows, as one one-hot matmul against the group's ``fine`` planes
   with its own thresholds ``t_eff``: the byte planes of ``d16`` (the
   u16 test ``sum16 - t >= 0``) or the u8 cells (``sum8 - t >= 0``),
   exact either way (see :func:`phase_c_filters`);
4. pairs: ``torch.nonzero`` of the phase-C mask, which lists them in
   ascending (position, motif lane) order -- the order the JAX bit-pack
   and lowest-set-bit extraction produce;
5. :func:`rescore_multi`: the exact f32 score of each pair, and the keep
   mask ``score >= threshold``.

The u16 test has no false negatives against the f32 threshold
(:func:`fine_discretize`), so the hits are the exact ones; the u8 test
follows the reference's saturating rule (no false negatives on sequences
without wildcards).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import multi_kernel

__all__ = [
    "fine_discretize",
    "fine_thresholds",
    "unreachable_thresholds",
    "ragged_widths",
    "pack_filters_fine",
    "pack_filters_fine_i8",
    "pack_filters_k3",
    "pack_filters_k5",
    "pack_filters_k4",
    "phase_c_filters",
    "stack_motifs",
    "pack_motif_group",
    "group_bucket",
    "DENSE_BUCKET",
    "pack_dense_motif",
    "group_to_device",
    "candidates",
    "phase_c",
    "phase_c_pairs",
    "rescore_multi",
    "PREFILTERS",
    "scan_multi_core",
    "group_from_filters",
    "scan_multi_segment_fused",
    "scan_groups",
    "sorted_hits",
    "route_motifs",
    "pack_database",
    "pack_filters_u8",
    "database_groups",
]

#: Bound on the ``[candidates, 2 * motif lanes]`` f32 product of one
#: phase-C block (elements; 512 MiB, about 1.5 GiB of scratch with its
#: int32 copies).  Swept on an NVIDIA H100 80GB HBM3 (700 W) over the
#: 4,692-PSSM database scan of a 4.6 Mbp genome (~250,000 candidates):
#: ``scan_arrays`` wall 131-162 ms at 2**22, 71 ms at 2**25, 61 ms at
#: 2**27 -- fewer, larger matmuls.
PHASE_C_ELEMS = 1 << 27

#: Pairs per exact-rescore block (bounds the ``[pairs, m]`` gathers);
#: 2**18 was the best of 2**14, 2**16 and 2**18 in the same sweep.
RESCORE_BLOCK = 1 << 18

#: ``t_eff`` of a lane that never passes: K3's, and K5's (the JAX u16
#: filters' -1024 hi guard, ``256 * 1024``).
K3_NEVER = 1 << 26
K5_NEVER = 256 * 1024


# -- host packers: byte-identical to lightmotif_tpu.ops.multi -----------------


def fine_discretize(pssm_stack):
    """u16 discretization of a zero-padded PSSM stack.

    The reference's u8 quantization (per-row min offsets,
    over-estimating ``ceil``) at 16-bit resolution, in f64, with 65534
    as the denominator.  Returns ``(data16 uint32 [M, m, K], factor [M]
    f64, offset [M] f64)``.  ``data16[j, s] >= (pssm[j, s] - offsets[j])
    / factor`` cell by cell, so a window with ``score >= t`` has
    ``sum16 >= t16`` (:func:`fine_thresholds`): the u16 test has no false
    negatives.
    """
    x = np.asarray(pssm_stack, np.float64)
    body = x[:, :, :-1] if x.shape[2] > 1 else x
    with np.errstate(invalid="ignore"):
        finite = np.where(np.isfinite(body), body, -np.inf)
        row_max = finite.max(axis=2)
        row_max = np.where(np.isfinite(row_max), row_max, 0.0)
        max_score = row_max.sum(axis=1)
        repl = np.where(np.isinf(body), -max_score[:, None, None], body)
        offsets = repl.min(axis=2)
        offset = offsets.sum(axis=1)
        span = max_score - offset
        factor = np.where(span > 0, span, 1.0) / 65534.0
        scaled = np.ceil((x - offsets[:, :, None]) / factor[:, None, None])
    data16 = np.clip(
        np.nan_to_num(scaled, nan=0.0, posinf=65535.0, neginf=0.0),
        0, 65535).astype(np.uint32)
    return data16, factor, offset


def fine_thresholds(thresholds, factor, offset):
    """f32 thresholds -> u16 thresholds, floored.

    Finite thresholds clamp into the passable range [0, 65535] (a window
    may score past the body maximum through a wildcard cell, and then
    has ``sum16 >= 65535``); ``+inf`` and NaN map to the never-pass
    sentinel 65536, ``-inf`` to 0."""
    t = np.asarray(thresholds, np.float64)
    with np.errstate(invalid="ignore"):
        t16 = np.floor((t - offset) / factor)
    return np.where(
        np.isfinite(t),
        np.minimum(np.maximum(t16, 0.0), 65535.0),
        np.where(t < 0, 0.0, 65536.0),
    ).astype(np.int64)


def unreachable_thresholds(pssm_stack, thresholds):
    """Boolean ``[M]``: finite thresholds no window can reach.

    The bound is the f64 sum of the row maxima over every column (the
    wildcard included) plus a bound on the f32 rounding of a sequential
    sum of ``m`` terms; only thresholds strictly above it are marked.
    A row of ``-inf`` makes every finite threshold unreachable."""
    x = np.asarray(pssm_stack, np.float64)
    m = x.shape[1] or 1
    row_max = x.max(axis=2) if x.shape[2] else np.full(x.shape[:2], -np.inf)
    bound = row_max.sum(axis=1)
    t = np.asarray(thresholds, np.float64)
    finite_bound = np.isfinite(bound)
    with np.errstate(invalid="ignore"):
        mag = np.where(np.isfinite(row_max), np.abs(row_max), 0.0).sum(axis=1)
        margin = mag * m * 2.0 ** -23
        above = t > bound + margin
    return np.isfinite(t) & np.where(finite_bound, above, True)


def ragged_widths(f_hi, f_lo, k: int) -> tuple[int, ...]:
    """Per-contraction-block motif-lane suffix widths of the JAX ragged
    prefilter (power-of-two >= 128, non-increasing, ``widths[0] =
    m_pad``), from the content of the packed filters.  The port's
    kernels need no widths; ``pack_filters_fine_i8`` folds them into
    ``adj``, so they are kept for byte parity."""
    m_pad = f_hi.shape[1]
    n_blocks = f_hi.shape[0] // multi_kernel.MAX_MK
    if m_pad % 128:
        return (m_pad,) * n_blocks
    needs = [m_pad]
    for b in range(1, n_blocks):
        rows = slice(b * multi_kernel.MAX_MK, (b + 1) * multi_kernel.MAX_MK)
        nz = (np.abs(f_hi[rows]) + np.abs(f_lo[rows])).any(axis=0)
        first = int(np.argmax(nz)) if nz.any() else m_pad
        needs.append(m_pad - first)
    # widths must not increase: widen earlier blocks to cover later ones
    for b in range(n_blocks - 2, 0, -1):
        needs[b] = max(needs[b], needs[b + 1])
    widths = [m_pad]
    for need in needs[1:]:
        w = 128
        while w < need:
            w *= 2
        widths.append(min(w, m_pad))
    return tuple(widths)


def pack_filters_fine(data16, t16, k: int):
    """The JAX hi/lo byte filter pair (bf16 layout, threshold halves in
    the constant slot ``lanes - 1``, never-pass lanes with a -1024 hi
    guard)."""
    mcount = data16.shape[0]
    lanes = multi_kernel._lanes_for(k)
    hi = multi_kernel.pack_slots((data16 >> 8).astype(np.float32), k)
    lo = multi_kernel.pack_slots((data16 & 255).astype(np.float32), k)
    t16 = np.asarray(t16, np.int64)
    never = t16 > 65535
    tc = np.clip(t16, 0, 65535)
    hi[lanes - 1, :mcount] = -np.where(
        never, 1024, tc >> 8).astype(np.float32)
    lo[lanes - 1, :mcount] = -np.where(
        never, 0, tc & 255).astype(np.float32)
    hi[lanes - 1, mcount:] = -1024.0
    return hi, lo


def pack_filters_fine_i8(data16, t16, k: int, widths):
    """The JAX int8 byte-plane filters and int32 adjustment of
    ``prefilter_any8``: cells shifted by -128, ``adj = 128 * 257 * R_mo
    - t16`` (``-2**26`` for never-pass lanes).  Returns ``(hi8 int8,
    lo8 int8, adj int32 [m_pad, 1])``."""
    mcount, m_max, _ = data16.shape
    lanes = multi_kernel._lanes_for(k)
    rpb = multi_kernel.MAX_MK // lanes
    bpw = multi_kernel.BITS_PER_WORD
    m_pad = -(-mcount // bpw) * bpw
    n_blocks = -(-m_max // rpb)
    hi = np.zeros((n_blocks * multi_kernel.MAX_MK, m_pad), np.int16)
    lo = np.zeros_like(hi)
    for g in range(n_blocks * rpb):
        r = (g // rpb) * multi_kernel.MAX_MK + (g % rpb) * lanes
        hi[r:r + k] = -128
        lo[r:r + k] = -128
        if g < m_max:
            hi[r:r + k, :mcount] += (data16[:, g, :] >> 8).T
            lo[r:r + k, :mcount] += (data16[:, g, :] & 255).T
    r_mo = np.zeros(m_pad, np.int64)
    for wd in widths:
        r_mo[m_pad - wd:] += rpb
    t = np.full(m_pad, 1 << 26, np.int64)
    tt = np.asarray(t16, np.int64)
    t[:mcount] = np.where(tt > 65535, 1 << 26, np.clip(tt, 0, 65535))
    adj = (128 * 257 * r_mo - t).astype(np.int32).reshape(m_pad, 1)
    return hi.astype(np.int8), lo.astype(np.int8), adj


def _plane_table(cells, t_eff):
    """The byte planes of the port's prefilter kernel from per-lane cells.

    ``cells``: integer ``[m_pad, m, K]``, ``m_pad`` a multiple of
    :data:`.multi_kernel.K3_LANES`; ``t_eff``: ``[m_pad]``.  Each (lane,
    row) is shifted by its minimum over the symbols and the sum of a
    lane's shifts is taken off its threshold: a window reads exactly one
    symbol of every row, so every value ``sum_j cell - t_eff`` stays the
    same, and the shifted cells are unsigned.  They go into the fewest
    byte planes that hold them (at most :data:`.multi_kernel.MAX_PLANES`);
    cells whose window sums could leave int32 are refused.

    Returns ``planes`` uint8 ``[P, chunks, K3_LANES, rows, K]`` with
    ``planes[q, c, l, j, s] = (shifted[c * K3_LANES + l, j, s] >> 8q) &
    255`` (``rows``: ``m`` padded with zero rows until ``rows * K`` is a
    multiple of :data:`.multi_kernel.ROW_BYTES`), ``chunk_m`` int32
    ``[chunks]`` (one past the last row with a nonzero shifted cell in
    the chunk: the kernel runs no k-step past it, and those rows are
    zero, so no sum changes) and the shifted ``t_eff`` as int32.  Host
    numpy only: the plane count and bytes are fixed here, once, and a
    launch reads nothing back from the device to learn them."""
    cells = np.asarray(cells, np.int64)
    m_pad, m, k = cells.shape
    lanes = multi_kernel.K3_LANES
    shift = cells.min(axis=2) if cells.size else np.zeros((m_pad, m), np.int64)
    shifted = cells - shift[:, :, None]
    t = np.asarray(t_eff, np.int64).reshape(-1) - shift.sum(axis=1)
    top = int(shifted.max()) if shifted.size else 0
    n_planes = max(1, -(-top.bit_length() // 8))
    # every value and partial sum must be an exact int32
    bound = shifted.max(axis=2, initial=0).sum(axis=1) + np.abs(t)
    if n_planes > multi_kernel.MAX_PLANES or bound.max(initial=0) >= 1 << 31:
        raise ValueError("prefilter cells or thresholds out of the kernel's int32 range")
    unit = multi_kernel.ROW_BYTES // math.gcd(k, multi_kernel.ROW_BYTES)
    rows = -(-m // unit) * unit
    full = np.zeros((m_pad, rows, k), np.int64)
    full[:, :m] = shifted
    planes = np.stack([(full >> (8 * q)) & 255 for q in range(n_planes)]).astype(
        np.uint8).reshape(n_planes, m_pad // lanes, lanes, rows, k)
    nz = (full != 0).any(axis=2).reshape(m_pad // lanes, lanes, rows).any(axis=1)
    chunk_m = np.where(nz.any(axis=1), rows - np.argmax(nz[:, ::-1], axis=1), 0)
    return planes, chunk_m.astype(np.int32), t.astype(np.int32)


def _k3_thresholds(t16, m_pad: int, never: int) -> np.ndarray:
    """int64 ``[m_pad]``: ``clip(t16, 0, 65535)``, or ``never`` for
    never-pass (``t16 > 65535``) and padded lanes."""
    tt = np.asarray(t16, np.int64)
    t_eff = np.full(m_pad, never, np.int64)
    t_eff[: tt.size] = np.where(tt > 65535, never, np.clip(tt, 0, 65535))
    return t_eff


def pack_filters_k3(data16, t16, never: int = K3_NEVER):
    """The filters of the port's K3 (:func:`.multi_kernel.prefilter_any8`).

    ``data16``: ``[M, m, K]`` u16 cells; ``t16``: ``[M]`` u16 thresholds
    (65536 = never pass).  Lanes pad to :data:`.multi_kernel.
    BITS_PER_WORD` like the JAX filters.  Returns ``(planes, chunk_m,
    t_eff)`` of :func:`_plane_table` for the thresholds ``clip(t16, 0,
    65535)``, or ``never`` for never-pass and padded lanes -- the JAX
    kernel's values exactly (``adj`` minus its byte-plane shift).
    """
    mcount, m, k = data16.shape
    bpw = multi_kernel.BITS_PER_WORD
    m_pad = -(-mcount // bpw) * bpw
    d = np.zeros((m_pad, m, k), np.int64)
    d[:mcount] = data16
    return _plane_table(d, _k3_thresholds(t16, m_pad, never))


def pack_filters_k5(data16, t16):
    """The filters of the port's K5 (:func:`.multi_kernel.prefilter_any16`):
    K3's planes, with never-pass and padded lanes at 262144, the value
    the JAX u16 filters' -1024 hi guard gives (:func:`pack_filters_fine`).
    A never-pass lane's ``sum16 - 262144`` can reach 0 on long wildcard
    runs (wildcard cells may exceed the body maximum); the value is the
    JAX one all the same."""
    return pack_filters_k3(data16, t16, never=K5_NEVER)


def _bf16(x) -> np.ndarray:
    """f32 values rounded to bf16 (to nearest, ties to even) and back,
    as the JAX kernels cast their filters."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return t.to(torch.bfloat16).to(torch.float32).numpy()


def _slot_cells(filters, k: int, widths=None) -> np.ndarray:
    """Per-lane cells ``[m_pad, n_blocks * rpb, K]`` of a filter in the
    JAX slot layout (:func:`.multi_kernel.pack_slots`).  Under ragged
    ``widths`` contraction block ``b`` covers only the last ``widths[b]``
    lanes; the cells it does not cover are zero, as the JAX kernels
    never read them."""
    f = np.asarray(filters)
    lanes = multi_kernel._lanes_for(k)
    rpb = multi_kernel.MAX_MK // lanes
    mk = multi_kernel.MAX_MK
    n_blocks, m_pad = f.shape[0] // mk, f.shape[1]
    if f.shape[0] % mk or m_pad % multi_kernel.BITS_PER_WORD:
        raise ValueError(f"filters of shape {f.shape} are not in the slot layout")
    cells = (f.reshape(n_blocks, rpb, lanes, m_pad)[:, :, :k]
             .reshape(n_blocks * rpb, k, m_pad).transpose(2, 0, 1).copy())
    if widths is not None:
        if len(widths) != n_blocks:
            raise ValueError(f"{len(widths)} widths for {n_blocks} contraction blocks")
        for b, wd in enumerate(widths):
            cells[: m_pad - wd, b * rpb:(b + 1) * rpb] = 0
    return cells


def _integers(x, what: str) -> np.ndarray:
    if not (np.isfinite(x).all() and np.array_equal(x, np.round(x))):
        raise ValueError(f"{what} must hold integers")
    return x.astype(np.int64)


def _exact_sums(cells, t_eff, what: str) -> None:
    # the JAX kernels sum in f32: exact only below 2**24
    bound = np.abs(cells).max(axis=2).sum(axis=1) + np.abs(t_eff)
    if bound.size and bound.max() >= 1 << 24:
        raise ValueError(f"{what}: a window sum may reach 2**24, where the JAX "
                         "package's f32 sums are no longer exact")


def _cells_k4(filters_t, k: int):
    """u8 cells and thresholds of the JAX ``filters_t``, after its bf16
    cast: ``(cells [m_pad, n_blocks * rpb, K], t4 [m_pad])``."""
    f = _integers(_bf16(filters_t), "filters_t after the bf16 cast")
    t4 = -f[multi_kernel._lanes_for(k) - 1]
    cells = _slot_cells(f, k)
    _exact_sums(cells, t4, "filters_t")
    return cells, t4


def _cells_fine(f_hi, f_lo, k: int, widths=None):
    """u16 cells and thresholds of the JAX ``filters_fine`` (hi/lo byte
    planes, threshold halves in the constant slot): ``(d16, t5)``."""
    hi = _integers(_bf16(f_hi), "f_hi after the bf16 cast")
    lo = _integers(_bf16(f_lo), "f_lo after the bf16 cast")
    c = multi_kernel._lanes_for(k) - 1
    cells = 256 * _slot_cells(hi, k, widths) + _slot_cells(lo, k, widths)
    t5 = -(256 * hi[c] + lo[c])
    _exact_sums(cells, t5, "filters_fine")
    return cells, t5


def _cells_i8(hi8, lo8, adj, k: int, widths=None):
    """u16 cells and thresholds of the JAX ``filters_i8`` (-128-shifted
    int8 byte planes, ``adj = 128 * 257 * R_mo - t``): ``(d16, t3)``."""
    hi = np.asarray(hi8, np.int64) + 128
    lo = np.asarray(lo8, np.int64) + 128
    m_pad = hi.shape[1]
    n_blocks = hi.shape[0] // multi_kernel.MAX_MK
    rpb = multi_kernel.MAX_MK // multi_kernel._lanes_for(k)
    cells = 256 * _slot_cells(hi, k, widths) + _slot_cells(lo, k, widths)
    r_mo = np.zeros(m_pad, np.int64)
    for wd in (widths if widths is not None else (m_pad,) * n_blocks):
        r_mo[m_pad - wd:] += rpb
    t3 = 128 * 257 * r_mo - np.asarray(adj, np.int64).reshape(-1)
    return cells, t3


def pack_filters_k4(filters_t, k: int):
    """The filters of the port's K4 (:func:`.multi_kernel.prefilter_any`)
    from the JAX threshold-folded u8 filters
    (:func:`.multi_kernel.pack_filters_any`, or written by hand).

    The filters round through bf16 as the JAX kernel casts them; cells
    that are not integers then are refused, and so are filters whose
    window sums could reach ``2**24``.  Returns ``(planes, chunk_m, t4)``
    of :func:`_plane_table` for ``t4 = -filters_t[lanes - 1]``: the
    scaled threshold, 65536 for never-pass and padded lanes (less the
    lane's row shifts).  Trailing rows with no nonzero cell are cut
    (they add nothing)."""
    cells, t4 = _cells_k4(filters_t, k)
    return _plane_table(_trim_rows(cells), t4)


def _trim_rows(cells) -> np.ndarray:
    nz = np.nonzero(cells.any(axis=(0, 2)))[0]
    return cells[:, : int(nz[-1]) + 1 if nz.size else 1]


def phase_c_filters(data16, byte_planes: bool = True):
    """f32 filters of the phase-C matmul, row ``j * K + s``.

    With ``byte_planes`` (the u16 test): ``[m * K, 2 * m_pad]``, column
    ``mo`` holding ``data16[mo] >> 8`` and column ``m_pad + mo``
    ``data16[mo] & 255``.  Without (the u8 test): ``[m * K, m_pad]``, the
    cells themselves.

    One-hot windows times these filters give the sums exactly at every
    ``torch.set_float32_matmul_precision``: the operands are 0/1 and
    integers that bf16 holds exactly (bytes, or u8 cells after the JAX
    package's bf16 cast: at most 8 significant bits; TF32 keeps 11, bf16
    8), every product is exact, and every sum is an integer below
    ``2**24`` (``m * 255`` for a byte plane; :func:`pack_filters_k4`
    refuses u8 filters that could go past it)."""
    mcount, m, k = data16.shape
    bpw = multi_kernel.BITS_PER_WORD
    m_pad = -(-mcount // bpw) * bpw
    flat = np.asarray(data16).reshape(mcount, m * k).T
    if not byte_planes:
        out = np.zeros((m * k, m_pad), np.float32)
        out[:, :mcount] = flat
        return out
    out = np.zeros((m * k, 2 * m_pad), np.float32)
    out[:, :mcount] = flat >> 8
    out[:, m_pad:m_pad + mcount] = flat & 255
    return out


def stack_motifs(matrices, k: int):
    """Stack per-motif matrices ``[m_i, K]`` into ``[M, m_max, K]`` with
    zero padding, plus the lengths ``[M]``."""
    m_max = max(m.shape[0] for m in matrices)
    out = np.zeros((len(matrices), m_max, k), dtype=np.float32)
    lengths = np.zeros(len(matrices), dtype=np.int32)
    for i, m in enumerate(matrices):
        out[i, : m.shape[0]] = m
        lengths[i] = m.shape[0]
    return out, lengths


def pack_motif_group(ids, gm: int, m_bucket: int, pssm_stack,
                     thresholds, k: int):
    """Pack one length-sorted motif group.

    ``ids``: database indices of the group's motifs; ``gm``: the padded
    group size; ``m_bucket``: the group's row count (>= its longest
    motif).  Padded slots never pass: f32 threshold ``+inf``, u16
    threshold 65536, zero valid windows.  Provably unreachable
    thresholds fold to 65536 too.

    Returns the JAX keys (``f_hi``, ``f_lo``, ``f_hi8``, ``f_lo8``,
    ``adj``, ``pssm``, ``th``, ``m_max``, ``count``, ``widths``,
    ``rsplits``, ``pre4``), each byte-identical to the JAX packer's,
    and the port's: ``k3`` (:func:`pack_filters_k3`), ``fine``
    (:func:`phase_c_filters`) and ``t_eff`` (phase C's u16 thresholds:
    ``k3``'s before its row shifts).
    """
    mw = min(m_bucket, pssm_stack.shape[1])
    th_g = np.full(gm, np.inf, np.float32)
    th_g[: len(ids)] = thresholds[ids]
    pssm_g = np.zeros((gm, m_bucket, pssm_stack.shape[2]), np.float32)
    pssm_g[: len(ids), :mw] = pssm_stack[ids][:, :mw]
    d16, f16, off16 = fine_discretize(pssm_g)
    t16 = fine_thresholds(th_g, f16, off16)
    t16 = np.where(unreachable_thresholds(pssm_g, th_g), 65536, t16)
    f_hi, f_lo = pack_filters_fine(d16, t16, k)
    widths = ragged_widths(f_hi, f_lo, k)
    hi8, lo8, adj = pack_filters_fine_i8(d16, t16, k, widths)
    # length-class lane starts of the JAX staged rescore (which neither
    # package's scanner runs); kept for byte parity
    rpb = multi_kernel.MAX_MK // multi_kernel._lanes_for(k)
    nz_rows = np.abs(pssm_g).sum(axis=2) > 0
    m_eff = np.where(nz_rows.any(axis=1),
                     m_bucket - np.argmax(nz_rows[:, ::-1], axis=1), 0)
    n_blocks = -(-m_bucket // rpb)
    rsplits = []
    for b in range(1, n_blocks):
        sel = np.nonzero(m_eff > b * rpb)[0]
        rsplits.append(int(sel.min()) if sel.size else gm)
    for b in range(len(rsplits) - 2, -1, -1):
        rsplits[b] = min(rsplits[b], rsplits[b + 1])
    # prefix-4 rescore table: entry (mo, code) is the exact f32
    # sequential sum of rows 0..3 for the 4-symbol prefix ``code``
    # (base-K digits); DNA-sized alphabets only.  The JAX rescore may
    # start from it; the port's does not.  Kept for byte parity
    pre4 = None
    if k <= 8 and m_bucket >= 4:
        codes = np.arange(k ** 4)
        pre4 = pssm_g[:, 0, :][:, codes // k ** 3 % k].astype(np.float32)
        for j, sj in ((1, codes // k ** 2 % k), (2, codes // k % k),
                      (3, codes % k)):
            pre4 = pre4 + pssm_g[:, j, :][:, sj]
        pre4 = pre4.reshape(-1)
    return {
        "f_hi": f_hi,
        "f_lo": f_lo,
        "f_hi8": hi8,
        "f_lo8": lo8,
        "adj": adj,
        "pssm": pssm_g,
        "th": th_g,
        "m_max": m_bucket,
        "count": len(ids),
        "widths": widths,
        "rsplits": tuple(rsplits),
        "pre4": pre4,
        "k3": pack_filters_k3(d16, t16),
        "fine": phase_c_filters(d16),
        "t_eff": _k3_thresholds(t16, f_hi.shape[1], K3_NEVER).astype(np.int32),
    }


def group_bucket(m_g: int, rpb: int, multi_group: bool) -> int:
    """A group's motif-length bucket: whole contraction blocks when
    several groups share one shape, exact otherwise."""
    return (-(-m_g // rpb) * rpb) if multi_group else m_g


#: Dense-path motif lengths round up to this many PSSM rows.
DENSE_BUCKET = 32


def pack_dense_motif(pssm_data, k: int):
    """Pad a long motif's PSSM to the next :data:`DENSE_BUCKET` multiple
    of rows.  Returns ``(pssm_pad [m_b, k] f32, m_b)``; the zero rows
    add +0.0 to every window, as on the JAX dense path, so the f32 bits
    of both packages agree."""
    data = np.asarray(pssm_data, np.float32)
    m_i = data.shape[0]
    m_b = -(-m_i // DENSE_BUCKET) * DENSE_BUCKET
    pssm_pad = np.zeros((m_b, k), np.float32)
    pssm_pad[:m_i] = data
    return pssm_pad, m_b


# -- device stages ------------------------------------------------------------


def group_to_device(g: dict, device: torch.device) -> dict:
    """The tensors of a packed group that the device stages read (K3,
    and phase C on the u16 byte planes)."""
    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return {
        "k3": tuple(dev(a) for a in g["k3"]),
        "fine": dev(g["fine"]),
        "byte_planes": True,
        "t_eff": dev(g["t_eff"]),
        "pssm": dev(g["pssm"]),
        "th": dev(g["th"]),
        "m_max": g["m_max"],
    }


def _windows(chunk: torch.Tensor, positions: torch.Tensor, m: int,
             k: int) -> torch.Tensor:
    """int64 ``[n, m]`` ranks ``chunk[p + j]``; the wildcard past the end
    of the chunk and for ranks ``>= K``."""
    lp = chunk.shape[0]
    idx = positions[:, None] + torch.arange(m, device=chunk.device)
    sym = chunk[idx.clamp(max=lp - 1)].to(torch.int64).clamp(max=k - 1)
    return torch.where(idx < lp, sym, k - 1)


def candidates(maxv: torch.Tensor) -> torch.Tensor:
    """Ascending window starts where some motif lane may pass (K3's
    ``max >= 0``); the count is exact."""
    return torch.nonzero(maxv >= 0).flatten()


def phase_c(chunk: torch.Tensor, positions: torch.Tensor, fine: torch.Tensor,
            t_eff: torch.Tensor, m: int, k: int, byte_planes: bool = True) -> torch.Tensor:
    """``sum - t_eff`` of every (candidate, motif lane) as int32
    ``[n, m_pad]``, exactly (see :func:`phase_c_filters`): ``sum16`` when
    ``fine`` holds the two byte planes (``byte_planes``), else the u8 sum
    of the cells it holds."""
    n = positions.shape[0]
    m_pad = t_eff.shape[0]
    sym = _windows(chunk, positions, m, k)
    onehot = torch.zeros((n, m * k), dtype=torch.float32, device=chunk.device)
    onehot.scatter_(1, sym + torch.arange(m, device=chunk.device) * k, 1.0)
    planes = (onehot @ fine).to(torch.int32)  # [n, 2 * m_pad] or [n, m_pad]
    if not byte_planes:
        return planes - t_eff
    return 256 * planes[:, :m_pad] + planes[:, m_pad:] - t_eff


def phase_c_pairs(chunk: torch.Tensor, cand: torch.Tensor, n_valid: torch.Tensor,
                  group: dict, k: int):
    """(position, motif lane) pairs that pass the group's phase-C test
    inside the lane's valid windows, in ascending (position, lane)
    order."""
    m_pad = group["t_eff"].shape[0]
    blk = max(1, PHASE_C_ELEMS // (2 * m_pad))
    rows, lanes = [], []
    for b0 in range(0, cand.shape[0], blk):
        pos = cand[b0 : b0 + blk]
        part = phase_c(chunk, pos, group["fine"], group["t_eff"],
                       group["m_max"], k, group["byte_planes"])
        mask = (part >= 0) & (pos[:, None] < n_valid[None, :])
        pair = torch.nonzero(mask)
        rows.append(pos[pair[:, 0]])
        lanes.append(pair[:, 1])
    if not rows:
        empty = torch.zeros(0, dtype=torch.int64, device=chunk.device)
        return empty, empty
    return torch.cat(rows), torch.cat(lanes)


def rescore_multi(chunk: torch.Tensor, pssms: torch.Tensor, positions: torch.Tensor,
                  lanes: torch.Tensor) -> torch.Tensor:
    """Exact f32 scores of (position, motif lane) pairs.

    The sequential ascending-j sum over every row of the group's
    ``[M, m, K]`` stack, written as a loop of elementwise adds starting
    from row 0's value; zero-padded rows add +0.0, as in the JAX
    package.  (The JAX package may start from its ``pre4`` prefix
    table instead; that gives the same bits, so the port has one path.)
    Every valid pair's window lies inside ``chunk``."""
    _, m, k = pssms.shape
    flat = pssms.reshape(-1)
    jj = torch.arange(m, device=chunk.device) * k
    out = torch.empty(positions.shape, dtype=torch.float32, device=chunk.device)
    for b0 in range(0, positions.shape[0], RESCORE_BLOCK):
        pos = positions[b0 : b0 + RESCORE_BLOCK]
        lane = lanes[b0 : b0 + RESCORE_BLOCK]
        sym = _windows(chunk, pos, m, k)
        val = flat[(lane * (m * k))[:, None] + jj + sym]
        acc = val[:, 0]
        for j in range(1, m):
            acc = acc + val[:, j]
        out[b0 : b0 + RESCORE_BLOCK] = acc
    return out


def _no_mark(stage: str, n: int) -> None:
    pass


#: The prefilter of each group key, in the JAX package's selection
#: order: ``filters_i8`` (K3), else ``filters_fine`` (K5), else
#: ``filters_t`` (K4).
PREFILTERS = {"k3": "prefilter_any8", "k5": "prefilter_any16", "k4": "prefilter_any"}


def scan_multi_core(chunk: torch.Tensor, n_valid: torch.Tensor, group: dict,
                    k: int, mark=None):
    """Hits of one motif group in one segment.

    ``chunk``: uint8 ranks of the segment's window starts plus the
    group's ``m - 1`` halo; ``n_valid``: int64 ``[m_pad]`` window starts
    of each lane that this segment owns (0 for padded lanes); ``group``:
    the device tensors of :func:`group_to_device` or
    :func:`group_from_filters`.  Returns ``(positions, lanes, scores)``
    of the kept hits in ascending (position, lane) order: positions
    relative to the chunk, lanes within the group, f32 scores.

    ``mark``, a timing hook, is called once each stage's work is queued
    with the stage's name and the count it produced: (the prefilter's
    key, window starts), ``("candidates", n)``, ``("phase_c", pairs)``,
    ``("rescore", kept hits)``.
    """
    mark = mark or _no_mark
    mode = next(name for name in PREFILTERS if name in group)
    maxv = getattr(multi_kernel, PREFILTERS[mode])(chunk, *group[mode])
    mark(mode, maxv.shape[0])
    cand = candidates(maxv)
    mark("candidates", cand.shape[0])
    positions, lanes = phase_c_pairs(chunk, cand, n_valid, group, k)
    mark("phase_c", positions.shape[0])
    scores = rescore_multi(chunk, group["pssm"], positions, lanes)
    keep = scores >= group["th"][lanes]
    positions, lanes, scores = positions[keep], lanes[keep], scores[keep]
    mark("rescore", positions.shape[0])
    return positions, lanes, scores


def group_from_filters(pssms, thresholds, m_max: int, k: int, device,
                       filters_t=None, filters_fine=None, widths=None,
                       filters_i8=None) -> dict:
    """The device group of :func:`scan_multi_core` from the JAX filters
    as the JAX ``scan_multi_core`` takes them.

    The prefilter is chosen in the JAX order: ``filters_i8`` (``(hi8,
    lo8, adj)``) runs K3, else ``filters_fine`` (``(f_hi, f_lo)``) K5,
    else ``filters_t`` K4; ``widths`` are the ragged widths of the first
    two.  Phase C reads ``filters_fine`` when it is given (the u16 test,
    its thresholds ``t5``), else ``filters_t`` (the u8 test, ``t4``), as
    the JAX phase C does, so ``filters_i8`` alone is refused.  Its
    windows have ``m_max`` rows.  ``pssms`` ``[M, m, K]`` and
    ``thresholds`` ``[M]`` are the exact rescore's.
    """
    if filters_i8 is None and filters_fine is None and filters_t is None:
        raise ValueError("no prefilter filters given")
    if filters_fine is None and filters_t is None:
        raise ValueError("phase C needs filters_fine or filters_t")
    u16 = None if filters_fine is None else _cells_fine(*filters_fine, k, widths)
    u8 = None if filters_t is None else _cells_k4(filters_t, k)
    if filters_i8 is not None:
        mode, (cells, t_pre) = "k3", _cells_i8(*filters_i8, k, widths)
    else:
        mode, (cells, t_pre) = ("k5", u16) if u16 is not None else ("k4", u8)
    byte_planes = u16 is not None
    fine, t_c = u16 if byte_planes else u8
    planes = phase_c_filters(fine[:, :m_max], byte_planes=byte_planes)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return {
        mode: tuple(dev(a) for a in _plane_table(_trim_rows(cells), t_pre)),
        "fine": dev(planes),
        "byte_planes": byte_planes,
        "t_eff": dev(np.asarray(t_c, np.int32)),
        "pssm": dev(np.asarray(pssms, np.float32)),
        "th": dev(np.asarray(thresholds, np.float32)),
        "m_max": int(m_max),
    }


def scan_multi_segment_fused(seq, off, n_valid_here, filters_t, pssms,
                             thresholds, chunk_len: int, cap: int,
                             m_max: int, k: int, dense: bool = False,
                             cap_hits: int | None = None,
                             filters_fine=None, widths=None,
                             filters_i8=None, rsplits=None, pre4=None):
    """The kept hits of one segment, from the JAX package's arguments.

    Counterpart of the JAX ``scan_multi_segment_fused``: ``seq`` is a
    uint8 tensor on the device to run on, the segment is ``seq[off :
    off + chunk_len]``, ``n_valid_here`` holds the ``[1, m_pad]`` (or
    ``[m_pad]``) valid window starts of each lane, and the filters go
    through :func:`group_from_filters`.  ``cap``, ``cap_hits`` and
    ``dense`` size the JAX package's compaction buffers; compaction here
    is exact, so they are unused, and so are ``rsplits`` and ``pre4``
    (the port has one rescore, which gives the same bits).  Returns
    ``(positions, lanes, scores)`` of the kept hits in (position, lane)
    order: the JAX ``packed[:, :n_kept]``.

    Every call unpacks the filters and uploads the group again, a host
    cost paid per segment.  A loop over segments or groups should pack
    once (:func:`database_groups`, or :func:`group_from_filters` per
    group) and run :func:`scan_groups`.
    """
    group = group_from_filters(pssms, thresholds, m_max, k, seq.device,
                               filters_t=filters_t, filters_fine=filters_fine,
                               widths=widths, filters_i8=filters_i8)
    off = int(off)
    n_valid = torch.as_tensor(np.asarray(n_valid_here, np.int64).reshape(-1),
                              device=seq.device)
    return scan_multi_core(seq[off : off + chunk_len], n_valid, group, k)


def scan_groups(data: torch.Tensor, length: int, lengths, groups, k: int,
                segment: int, mark=None) -> list:
    """Hits of motif groups over a device sequence, segment by segment.

    ``data``: the uint8 ranks (padded past ``length``); ``lengths``: the
    motif length of each database index; each group, from
    :func:`group_to_device` or :func:`group_from_filters`, also holds
    its database indices as ``ids`` (numpy) and ``ids_dev`` (on the
    device).  Each segment carries its group's ``m - 1`` halo.  Returns
    one ``(positions, motif ids, scores)`` triple of device tensors per
    (group, segment) with a window to scan, in that order.
    """
    n_valid = np.maximum(length - np.asarray(lengths) + 1, 0).astype(np.int64)
    n_total = int(n_valid.max(initial=0))
    parts = []
    for group in groups:
        ids = group["ids"]
        m_pad = group["t_eff"].shape[0]
        for off in range(0, n_total, segment):
            n_here = np.zeros(m_pad, np.int64)
            n_here[: len(ids)] = np.clip(n_valid[ids] - off, 0, segment)
            n_max = int(n_here.max())
            if n_max == 0:
                continue
            # the segment's window starts plus the group's halo
            chunk = data[off : off + n_max + group["m_max"] - 1]
            pos, lanes, scores = scan_multi_core(
                chunk, torch.as_tensor(n_here, device=data.device), group, k, mark)
            parts.append((pos + off, group["ids_dev"][lanes], scores))
    return parts


def sorted_hits(parts):
    """Hit arrays ``(motif_ids int32, positions int64, scores float32)``
    on the host, ordered by (motif, position), from ``(positions, motif
    ids, scores)`` device triples such as :func:`scan_groups` returns."""
    if not parts:
        return (np.zeros(0, np.int32), np.zeros(0, np.int64),
                np.zeros(0, np.float32))
    positions = torch.cat([p for p, _, _ in parts])
    motif_ids = torch.cat([m for _, m, _ in parts])
    scores = torch.cat([s for _, _, s in parts])
    # (motif, position) is unique per hit: one sort of the packed key
    order = torch.argsort((motif_ids << 40) | positions)
    return (motif_ids[order].to(torch.int32).cpu().numpy(),
            positions[order].cpu().numpy(),
            scores[order].cpu().numpy())


# -- a whole motif database ---------------------------------------------------


def route_motifs(pssm_stack, lengths, thresholds, k: int, dense_m_limit: int):
    """Route a motif database as the JAX ``MultiScanner`` does.

    Motifs longer than ``dense_m_limit`` take the dense path, motifs
    whose thresholds no window can reach (:func:`unreachable_thresholds`)
    are dropped, and the rest go through the prefilter groups; when the
    prefilter has no geometry for them (:func:`.multi_kernel.
    supports_fused`), every live motif takes the dense path.  Returns
    ``(short_idx, dense_idx)``: the database indices of the groups'
    motifs, sorted by length (stable), and of the dense path's."""
    lengths = np.asarray(lengths)
    long_sel = lengths > dense_m_limit
    live_sel = ~unreachable_thresholds(pssm_stack, thresholds)
    short_idx = np.nonzero(~long_sel & live_sel)[0]
    m_short = int(lengths[short_idx].max()) if short_idx.size else 0
    if short_idx.size and multi_kernel.supports_fused(m_short, k, int(short_idx.size)):
        dense_idx = np.nonzero(long_sel & live_sel)[0]
    else:
        dense_idx = np.nonzero(live_sel)[0]
        short_idx = np.zeros(0, np.int64)
    # length-sorted, so each group's rows match its longest motif
    return short_idx[np.argsort(lengths[short_idx], kind="stable")], dense_idx


def pack_database(pssm_stack, lengths, thresholds, ids, k: int, group_motifs: int,
                  single_bucket: bool = False):
    """Yield ``(group ids, packed group)`` of each motif group of the
    database motifs ``ids`` (length-sorted: :func:`route_motifs`'
    ``short_idx``), in groups of ``group_motifs``.

    The groups are :func:`pack_motif_group`'s, as the JAX
    ``MultiScanner`` packs them: when there are several, every group has
    ``group_motifs`` lanes and rows in whole contraction blocks
    (:func:`group_bucket`); ``single_bucket`` gives every group the rows
    of the longest motif of ``ids``."""
    ids = np.asarray(ids)
    n = int(ids.size)
    gsize = min(group_motifs, n)
    gstarts = range(0, n, gsize) if gsize else range(0)
    multi_group = len(gstarts) > 1
    rpb = multi_kernel.MAX_MK // multi_kernel._lanes_for(k)
    for s in gstarts:
        g_ids = ids[s:s + gsize]
        m_bkt = int(np.asarray(lengths)[ids if single_bucket else g_ids].max())
        yield g_ids, pack_motif_group(
            g_ids, gsize if multi_group else len(g_ids),
            group_bucket(m_bkt, rpb, multi_group), pssm_stack, thresholds, k)


def pack_filters_u8(g: dict, ids, dm_stack, t_scaled, k: int) -> np.ndarray:
    """The JAX u8 filters ``filters_t`` (:func:`.multi_kernel.
    pack_filters_any`) of a packed group at its lanes and rows.

    ``g``: :func:`pack_motif_group`'s arrays of the database motifs
    ``ids``; ``dm_stack``: the database's u8 discrete matrices ``[M, m,
    K]`` and ``t_scaled`` their scaled thresholds ``[M]`` (each PSSM's
    ``to_discrete()`` and its ``scale(threshold)``).  Padded lanes never
    pass."""
    gm, m_bucket, _ = g["pssm"].shape
    ids = np.asarray(ids)
    mw = min(m_bucket, dm_stack.shape[1])
    dm = np.zeros((gm, m_bucket, k), np.float32)
    dm[: ids.size, :mw] = np.asarray(dm_stack, np.float32)[ids][:, :mw]
    t = np.full(gm, 256, np.int64)  # above the u8 range: never passes
    t[: ids.size] = np.asarray(t_scaled)[ids]
    return multi_kernel.pack_filters_any(dm, t, k)


def database_groups(pssm_stack, lengths, thresholds, ids, k: int, device,
                    group_motifs: int, prefilter: str = "k3",
                    single_bucket: bool = False, discrete=None) -> list:
    """The device groups of :func:`scan_groups` for the database motifs
    ``ids`` in one prefilter mode, each with its ``ids`` and ``ids_dev``.

    The groups are :func:`pack_database`'s.  ``prefilter``: ``"k3"``,
    the ``MultiScanner``'s (K3, phase C on the u16 byte planes);
    ``"k5"``, the u16 mode, from each group's JAX ``filters_fine`` and
    ragged ``widths``; ``"k4"``, the u8 mode, from its JAX ``filters_t``
    built by :func:`pack_filters_u8` out of ``discrete = (dm_stack,
    t_scaled)``.  The u8 candidate union saturates large groups, so the
    u8 mode wants small ``group_motifs`` (the JAX package's note at
    ``scan_multi_core``'s u16 prefilter)."""
    if prefilter not in PREFILTERS:
        raise ValueError(f"unknown prefilter {prefilter!r}; one of {sorted(PREFILTERS)}")
    if prefilter == "k4" and discrete is None:
        raise ValueError("the u8 mode needs discrete=(dm_stack, t_scaled)")
    groups = []
    for g_ids, g in pack_database(pssm_stack, lengths, thresholds, ids, k,
                                  group_motifs, single_bucket):
        if prefilter == "k3":
            group = group_to_device(g, device)
        else:
            filters = ({"filters_fine": (g["f_hi"], g["f_lo"]), "widths": g["widths"]}
                       if prefilter == "k5" else
                       {"filters_t": pack_filters_u8(g, g_ids, *discrete, k)})
            group = group_from_filters(g["pssm"], g["th"], g["m_max"], k, device,
                                       **filters)
        group["ids"] = g_ids
        group["ids_dev"] = torch.as_tensor(g_ids, device=device)
        groups.append(group)
    return groups
