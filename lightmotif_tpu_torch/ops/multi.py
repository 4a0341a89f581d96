"""Multi-motif scanning: a whole motif group against a sequence at once.

Counterpart of :mod:`lightmotif_tpu.ops.multi`.  The host packers
(:func:`fine_discretize` to :func:`pack_dense_motif`) are numpy and
give the JAX package's arrays byte for byte; :func:`pack_motif_group`
adds the layouts the port's device stages read (``k3`` and
``phase_c``), and :func:`group_from_filters` builds them from the JAX filters of any
prefilter mode.  :func:`route_motifs`, :func:`pack_database` and
:func:`database_groups` split a whole motif database into those groups,
in any mode, for :func:`scan_groups`.

The device stages (:func:`scan_multi_core`) are the JAX
``scan_multi_core`` on one segment, at its fixed capacities, with no
read of the device:

1. the prefilter, chosen in the JAX order from the filters the group
   holds: K3 (``k3``, the JAX ``filters_i8``), else K5 (``k5``,
   ``filters_fine``), else K4 (``k4``, the u8 ``filters_t``); each gives
   ``max_mo (sum - t_eff)`` of every window start, and ``>= 0`` marks a
   candidate (:mod:`.multi_kernel` states the three formulas);
2. candidates: the first ``cap`` of them, compacted by
   ``torch.nonzero_static``, and their exact count, on the device
   (:func:`compact_candidates`);
3. phase C (:func:`.multi_stages.phase_c_bits`): the test per
   (candidate, motif lane) inside the lane's valid windows, against the
   group's ``phase_c`` cells and thresholds: the byte planes of ``d16``
   (the u16 test ``sum16 - t >= 0``) or the u8 cells (``sum8 - t >=
   0``), exact either way, as pass bits, and each row's set bits;
4. pairs, rescore, keep (:func:`.multi_stages.pairs_rescore`): the
   pairs of those bits in ascending (position, motif lane) order -- the
   order the JAX bit-pack and lowest-set-bit extraction produce -- within
   the JAX core's ``cap_hits``, their exact f32 scores, and the hits
   with ``score >= threshold`` front-compacted into ``packed[3,
   cap_hits]``, with ``counts = [candidates, hit_need, n_kept, valid]``.

A caller re-runs a segment with doubled capacities while ``candidates >
cap`` or ``hit_need > cap_hits`` (:func:`settle_entries`); the hits are
exact at any capacity, only the number of reads changes.  ``valid`` is
always 1: compaction at ``cap`` is complete at any density (the JAX
package's ``dense`` compaction).

The u16 test has no false negatives against the f32 threshold
(:func:`fine_discretize`), so the hits are the exact ones; the u8 test
follows the reference's saturating rule (no false negatives on sequences
without wildcards).
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils import profiling
from . import kernels, multi_kernel, multi_stages
from .multi_stages import phase_c, rescore_multi

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
    "stack_motifs",
    "pack_motif_group",
    "group_bucket",
    "DENSE_BUCKET",
    "pack_dense_motif",
    "group_to_device",
    "lanes",
    "compact_candidates",
    "phase_c",
    "rescore_multi",
    "PREFILTERS",
    "scan_multi_core",
    "dense_core",
    "group_from_filters",
    "scan_multi_segment_fused",
    "DEFAULT_CAPACITY",
    "HEAD_SLOTS",
    "RERUNS",
    "reset_reruns",
    "head_width",
    "ratchet",
    "seed_capacities",
    "Entry",
    "group_steps",
    "scan_groups",
    "dense_entry",
    "read_host",
    "HostReader",
    "head_widths",
    "heads_info",
    "sorted_heads",
    "merge_sorted_heads",
    "unpack_heads",
    "read_sorted",
    "settle_entries",
    "fits",
    "collect_device",
    "entry_counts",
    "merge_hits",
    "collect_entries",
    "sorted_hits",
    "route_motifs",
    "pack_database",
    "pack_filters_u8",
    "database_groups",
]

#: Seed candidate capacity of a segment, the JAX package's; a group's
#: hit capacity starts at ``DEFAULT_CAPACITY * max(1, lanes // 1024)``
#: (:func:`seed_capacities`).  Both ratchet per group.
DEFAULT_CAPACITY = 1 << 16

#: Hit slots read with the counters of an entry before any hint
#: (:func:`head_width`), the JAX package's.
HEAD_SLOTS = 8192

#: Entries re-run at larger capacities since the last
#: :func:`reset_reruns`: motif-group segments and dense motifs.
RERUNS = {"group": 0, "dense": 0}

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
    and the port's: ``k3`` (:func:`pack_filters_k3`); ``phase_c``, the
    planes of phase C's test (:func:`pack_filters_k5`: ``k3``'s planes,
    with the thresholds of the JAX ``filters_fine`` that the JAX phase C
    reads, never-pass and padded lanes at 262144); and ``t_eff``, ``k3``'s
    thresholds before its row shifts.
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
        "phase_c": pack_filters_k5(d16, t16),
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


def _dev(a, device) -> torch.Tensor:
    return torch.as_tensor(np.ascontiguousarray(a), device=device)


def _prefilter_to_device(packed, device) -> tuple:
    """Host prefilter filters ``(planes, chunk_m, t_eff)`` on the device,
    with the planes' blocks for the warpgroup kernel
    (:func:`.multi_kernel.gmma_blocks`) and, as host ints, their k-steps a
    lane tile (:func:`.multi_kernel.tile_ksteps`) after them."""
    planes, chunk_m, _ = packed
    ksteps = tuple(multi_kernel.tile_ksteps(chunk_m, planes.shape[-1]).tolist())
    return (*(_dev(a, device) for a in packed),
            _dev(multi_kernel.gmma_blocks(planes, chunk_m), device), ksteps)


def group_to_device(g: dict, device: torch.device) -> dict:
    """The tensors of a packed group that the device stages read: K3 (with
    its blocks), phase C's planes (K3's, shared) and thresholds, and the
    exact rescore's stack and thresholds."""
    k3 = _prefilter_to_device(g["k3"], device)
    return {
        "k3": k3,
        "phase_c": (k3[0], k3[1], _dev(g["phase_c"][2], device)),
        "pssm": _dev(g["pssm"], device),
        "th": _dev(g["th"], device),
        "m_max": g["m_max"],
    }


def lanes(group: dict) -> int:
    """A device group's motif lanes, padded to whole 16-lane words."""
    return group["phase_c"][2].shape[0]


def compact_candidates(maxv: torch.Tensor, cap: int):
    """The first ``cap`` window starts where some motif lane may pass, and
    their count, with no read of the device: ``(cand int64 [cap], count
    int64 [])``; slots past the count hold 0."""
    mask = maxv >= 0
    return torch.nonzero_static(mask, size=cap, fill_value=0).flatten(), mask.sum()


#: The prefilter of each group key, in the JAX package's selection
#: order: ``filters_i8`` (K3), else ``filters_fine`` (K5), else
#: ``filters_t`` (K4).
PREFILTERS = {"k3": "prefilter_any8", "k5": "prefilter_any16", "k4": "prefilter_any"}


def _check_capacities(cap: int, cap_hits: int, m_pad: int) -> None:
    if cap < 1 or cap_hits < 1:
        raise ValueError(f"capacities must be positive, got cap={cap}, cap_hits={cap_hits}")
    n_words = m_pad // multi_kernel.BITS_PER_WORD
    if min(cap, cap_hits) * n_words >= 2**31 or cap_hits * multi_kernel.BITS_PER_WORD >= 2**31:
        # the JAX core's guard, kept so that both refuse the same capacities
        raise OverflowError(
            f"hit capacity {cap_hits} (x {n_words} words / x "
            f"{multi_kernel.BITS_PER_WORD} bits) exceeds int32 indexing; lower the "
            "thresholds or scan fewer motifs per pass")


def scan_multi_core(chunk: torch.Tensor, n_valid: torch.Tensor, group: dict, k: int,
                    cap: int, cap_hits: int | None = None):
    """One motif group in one segment, at fixed capacities, with no read
    of the device: ``(counts int32 [4], packed int32 [3, cap_hits])``.

    ``chunk``: uint8 ranks of the segment's window starts plus the
    group's ``m - 1`` halo; ``n_valid``: int32 (or int64) ``[m_pad]``
    window starts of each lane that this segment owns (0 for padded
    lanes); ``group``: the device tensors of :func:`group_to_device` or
    :func:`group_from_filters`; ``cap`` bounds the candidates,
    ``cap_hits`` (default ``cap``) the pairs and the kept hits.
    ``packed[:, :n_kept]`` holds the kept hits in ascending (position,
    lane) order: positions relative to the chunk, lanes within the group,
    f32 bits; ``counts = [candidates, hit_need, n_kept, 1]``, the JAX
    core's (re-run with a larger ``cap`` while ``candidates > cap``, a
    larger ``cap_hits`` while ``hit_need > cap_hits``).

    Each stage's issue is a span (:func:`~..utils.profiling.span`):
    ``prefilter`` (its counts ``windows``, the window starts it tests, and
    :func:`.multi_kernel.issue_counts`' ``gmma`` and ``issued_ops``),
    ``exact.compact``, ``exact.phase_c`` and ``exact.pairs``.
    """
    cap = int(cap)
    cap_hits = cap if cap_hits is None else int(cap_hits)
    _check_capacities(cap, cap_hits, lanes(group))
    mode = next(name for name in PREFILTERS if name in group)
    with profiling.span("prefilter") as span:
        maxv = getattr(multi_kernel, PREFILTERS[mode])(chunk, *group[mode])
        if span:
            span.add(windows=maxv.shape[0],
                     **multi_kernel.issue_counts(chunk, *group[mode]))
    with profiling.span("exact.compact"):
        cand, count = compact_candidates(maxv, cap)
    with profiling.span("exact.phase_c"):
        bits, pcnt = multi_stages.phase_c_bits(chunk, cand, count, *group["phase_c"],
                                               n_valid.to(torch.int32))
    with profiling.span("exact.pairs"):
        return multi_stages.pairs_rescore(bits, pcnt, cand, count, chunk, group["pssm"],
                                          group["th"], cap_hits)


def dense_core(data: torch.Tensor, pssm: torch.Tensor, threshold: torch.Tensor,
               n_valid: int, cap: int):
    """One dense motif over a sequence, at a fixed capacity, with no read
    of the device (the JAX ``_dense_motif_scan_fn``): K1's exact scores of
    the first ``n_valid`` window starts, ``>= threshold`` (an f32 scalar
    on the device), the first ``cap`` hits.  Returns ``(counts int32 [4],
    packed int32 [3, cap])`` in the form of :func:`scan_multi_core`:
    ``counts = [hits, hits, min(hits, cap), 1]``, ``packed`` positions,
    lane 0 and f32 bits."""
    scores = kernels.score_f32(data, pssm, n_valid)[:n_valid]
    mask = scores >= threshold
    count = mask.sum()
    pos = torch.nonzero_static(mask, size=cap, fill_value=0).flatten()
    packed = torch.stack([pos.to(torch.int32), torch.zeros_like(pos, dtype=torch.int32),
                          scores[pos].view(torch.int32)])
    counts = torch.stack([count, count, count.clamp(max=cap), torch.ones_like(count)])
    return counts.to(torch.int32), packed


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
    cells_c, t_c = u16 if u16 is not None else u8
    pre = _plane_table(_trim_rows(cells), t_pre)
    planes_c, chunk_m_c, t_eff_c = _plane_table(_trim_rows(cells_c[:, :m_max]), t_c)
    pre_dev = _prefilter_to_device(pre, device)
    if np.array_equal(pre[0], planes_c) and np.array_equal(pre[1], chunk_m_c):
        pc_dev = (pre_dev[0], pre_dev[1], _dev(t_eff_c, device))  # one copy of the planes
    else:
        pc_dev = tuple(_dev(a, device) for a in (planes_c, chunk_m_c, t_eff_c))
    return {
        mode: pre_dev,
        "phase_c": pc_dev,
        "pssm": _dev(np.asarray(pssms, np.float32), device),
        "th": _dev(np.asarray(thresholds, np.float32), device),
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
    through :func:`group_from_filters`.  The segment runs
    :func:`scan_multi_core` at ``cap`` and ``cap_hits`` (default
    ``cap``), and again at doubled capacities while they overflow, so the
    result is exact at any capacity.  ``dense`` (the JAX compaction mode:
    the port's is always complete), ``rsplits`` and ``pre4`` (the port has
    one rescore, which gives the same bits) are unused.  Returns
    ``(positions, lanes, scores)``, the JAX ``packed[:, :n_kept]`` on
    ``seq``'s device: int64 positions in the segment, int64 lanes and f32
    scores, in (position, lane) order.

    Every call unpacks the filters and uploads the group again, a host
    cost paid per segment.  A loop over segments or groups should pack
    once (:func:`database_groups`, or :func:`group_from_filters` per
    group) and run :func:`scan_groups`.
    """
    group = group_from_filters(pssms, thresholds, m_max, k, seq.device,
                               filters_t=filters_t, filters_fine=filters_fine,
                               widths=widths, filters_i8=filters_i8)
    off = int(off)
    n_valid = torch.as_tensor(np.asarray(n_valid_here, np.int32).reshape(-1),
                              device=seq.device)
    entry = _core_entry(seq[off : off + chunk_len], n_valid, group, k, 0, 0, max(int(cap), 1),
                        max(int(cap_hits or cap), 1))
    (entry,), _ = settle_entries([entry], [read_host(entry.counts)], [0])
    packed = entry.packed[:, : int(read_host(entry.counts)[2])]
    return packed[0].to(torch.int64), packed[1].to(torch.int64), packed[2].view(torch.float32)


# -- entries: a group's segment, dispatched, and its read ------------------------


def reset_reruns() -> None:
    for kind in RERUNS:
        RERUNS[kind] = 0


def head_width(hint: int, cap: int) -> int:
    """Hit slots of an entry read with its counters, from a sticky
    ``n_kept`` hint: :data:`HEAD_SLOTS`, grown in steps of a quarter
    (8192, 16384, 24576, 32768, 40960, 51200, ...), at most ``cap``.  The
    JAX package's ladder; a head too short costs one more read."""
    width = HEAD_SLOTS
    while width < hint:
        width += max(HEAD_SLOTS, width >> 2)
    return min(cap, width)


def ratchet(cap: int, need: int) -> int:
    """The JAX package's capacity rule: ``cap``, or the next power of two
    at or above ``need`` where ``need`` outgrows it."""
    return max(cap, 1 << (need - 1).bit_length()) if need > cap else cap


def seed_capacities(group: dict, capacity: int = DEFAULT_CAPACITY) -> tuple:
    """A group's first ``(cap, cap_hits)``, as the JAX ``MultiScanner``
    seeds them: the hit capacity grows with the group's lanes, so a first
    whole-database scan does not overflow on the expected hits."""
    return capacity, capacity * max(1, group["pssm"].shape[0] // 1024)


class Entry(NamedTuple):
    """One dispatched segment of a motif group (or one dense motif): its
    counters and packed hits on the device (:func:`scan_multi_core`), the
    group (``ids`` maps its lanes to database indices), the offset of its
    chunk in the scanned sequence, its capacity key and capacities, and
    ``rerun(cap, cap_hits)``, which dispatches it again at other
    capacities and returns the new entry."""

    counts: torch.Tensor
    packed: torch.Tensor
    group: dict
    offset: int
    key: object
    cap: int
    cap_hits: int
    rerun: Callable


def _core_entry(chunk, n_valid, group, k, offset, key, cap, cap_hits) -> Entry:
    counts, packed = scan_multi_core(chunk, n_valid, group, k, cap, cap_hits)
    return Entry(counts, packed, group, offset, key, cap, cap_hits,
                 functools.partial(_core_entry, chunk, n_valid, group, k, offset, key))


def _group_tables(group: dict, lengths) -> torch.Tensor:
    """The group's tables of the scan on its device, uploaded once and
    kept in it: the database indices of its lanes (``ids_dev``) and, the
    one returned, the motif length of each lane (``len_dev``, int32
    ``[m_pad]``, ``2**30`` for padded lanes: no window)."""
    if "len_dev" not in group:
        device = group["pssm"].device
        m_pad = lanes(group)
        lens = np.full(m_pad, 1 << 30, np.int32)
        lens[: len(group["ids"])] = np.asarray(lengths)[group["ids"]]
        group["len_dev"] = torch.as_tensor(lens, device=device)
        group.setdefault("ids_dev", torch.as_tensor(np.asarray(group["ids"]), device=device))
    return group["len_dev"]


def group_steps(data: torch.Tensor, length: int, lengths, groups, k: int, segment: int,
                owned: int | None = None) -> list:
    """The (group, segment) steps of a scan of a device sequence, in that
    order: ``(group index, segment offset, run)`` for each with a window
    to scan, ``run(cap, cap_hits)`` dispatching it (:func:`scan_multi_core`
    and the lanes' valid windows before it, all on the device, no read)
    and returning its :class:`Entry`.

    The arguments are :func:`scan_groups`'.  A step's work depends only on
    its arguments and capacities, so a caller may record it once into a
    CUDA graph and replay it (:mod:`.graphs`)."""
    n_valid = np.maximum(length - np.asarray(lengths) + 1, 0).astype(np.int64)
    if owned is not None:
        n_valid = np.minimum(n_valid, int(owned))
    n_total = int(n_valid.max(initial=0))
    steps = []
    for gi, group in enumerate(groups):
        ids = group["ids"]
        lens = _group_tables(group, lengths)
        for off in range(0, n_total, segment):
            n_max = int(np.clip(n_valid[ids] - off, 0, segment).max(initial=0))
            if n_max == 0:
                continue
            # the segment's window starts plus the group's halo
            chunk = data[off : off + n_max + group["m_max"] - 1]
            top = segment if owned is None else min(segment, int(owned) - off)
            steps.append((gi, off, functools.partial(
                _segment_entry, chunk, length - off + 1, top, lens, group, k, off, gi)))
    return steps


def _segment_entry(chunk, window_end, top, lens, group, k, offset, key, cap,
                   cap_hits) -> Entry:
    # each lane's window starts in the segment, from its motif length
    lanes = (window_end - lens).clamp_(0, top)
    return _core_entry(chunk, lanes, group, k, offset, key, cap, cap_hits)


def scan_groups(data: torch.Tensor, length: int, lengths, groups, k: int,
                segment: int, state=None,
                capacity: int = DEFAULT_CAPACITY, owned: int | None = None) -> list:
    """Dispatch motif groups over a device sequence, segment by segment,
    with no read of the device.

    ``data``: the uint8 ranks (padded past ``length``); ``lengths``: the
    motif length of each database index; each group, from
    :func:`database_groups` (or :func:`group_to_device` /
    :func:`group_from_filters` with its database indices as ``ids``).
    Each segment carries its group's ``m - 1`` halo.  ``owned``: the
    window starts past which no hit is kept (a shard's share; every lane's
    valid windows are cut there on the device).  ``state`` maps a group's
    index to its ``(cap, cap_hits)`` (the scanner's ratchets); a group
    without one starts at :func:`seed_capacities` of ``capacity``.
    Returns one :class:`Entry` per (group, segment) with a window to scan,
    in that order (:func:`group_steps`, each run once);
    :func:`collect_entries` (or :func:`sorted_hits`) reads their hits.
    """
    state = {} if state is None else state
    return [run(*(state.get(gi) or seed_capacities(groups[gi], capacity)))
            for gi, _, run in group_steps(data, length, lengths, groups, k, segment, owned)]


def dense_entry(data: torch.Tensor, pssm: torch.Tensor, threshold: torch.Tensor,
                n_valid: int, cap: int, index: int) -> Entry:
    """The :class:`Entry` of one dense motif (:func:`dense_core`), database
    index ``index``, capacity key ``("dense", index)``."""
    counts, packed = dense_core(data, pssm, threshold, n_valid, cap)
    group = {"ids": np.asarray([index]),
             "ids_dev": torch.full((1,), index, dtype=torch.int64, device=data.device)}
    return Entry(counts, packed, group, 0, ("dense", index), cap, cap,
                 lambda c, h: dense_entry(data, pssm, threshold, n_valid, max(c, h), index))


def read_host(tensor: torch.Tensor) -> np.ndarray:
    """A tensor on the host, as numpy: from a CUDA device through a pinned
    buffer (a direct copy at the link's rate, not staged through pageable
    memory), then the device's stream synchronised.  For one-off reads; a
    scanner reads through its :class:`HostReader`."""
    if tensor.device.type != "cuda":
        return tensor.cpu().numpy()
    out = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
    out.copy_(tensor, non_blocking=True)
    torch.cuda.current_stream(tensor.device).synchronize()
    return out.numpy()


class HostReader:
    """The reads of one device through a pinned host buffer that it keeps
    and reuses, grown to the largest read, in place of an allocation per
    read.  :meth:`queue` queues a read, the copy into the buffer on the
    device's current stream, and returns its ``wait``: an event waited on
    (span ``fetch.wait``: the host blocked on the device) and the
    buffer's view as numpy, valid until the next :meth:`queue` (a caller
    keeps copies of what it keeps).  So several devices' reads can be
    queued before any is waited on.  A tensor on the CPU is returned as
    it is.  :attr:`nbytes` counts the bytes queued."""

    def __init__(self):
        self._buffer = None
        #: bytes of every read queued since the reader was made
        self.nbytes = 0

    def queue(self, tensor: torch.Tensor) -> Callable[[], np.ndarray]:
        nbytes = tensor.numel() * tensor.element_size()
        self.nbytes += nbytes
        if tensor.device.type != "cuda":
            host, done = tensor.cpu().numpy(), None
        else:
            if self._buffer is None or self._buffer.numel() < nbytes:
                size = max(nbytes, 2 * (0 if self._buffer is None else self._buffer.numel()))
                self._buffer = torch.empty(-(-size // 8) * 8, dtype=torch.uint8,
                                           pin_memory=True)
            out = self._buffer[:nbytes].view(tensor.dtype).view(tensor.shape)
            with torch.cuda.device(tensor.device):
                out.copy_(tensor, non_blocking=True)
                done = torch.cuda.Event()
                done.record()
            host = out.numpy()

        def wait() -> np.ndarray:
            with profiling.span("fetch.wait"):
                if done is not None:
                    done.synchronize()
            return host

        return wait

    def read(self, tensor: torch.Tensor) -> np.ndarray:
        """:meth:`queue`, then its wait."""
        return self.queue(tensor)()


def _overflowed(entry: Entry, counts) -> bool:
    n_cand, need, _, valid = (int(v) for v in counts)
    return n_cand > entry.cap or need > entry.cap_hits or not valid


def head_widths(entries: list, hints=None) -> list:
    """The head of each entry that :func:`read_sorted` reads with its
    counters: :func:`head_width` of its capacity key's hint."""
    hints = {} if hints is None else hints
    return [head_width(hints.get(e.key, 0), e.cap_hits) for e in entries]


def heads_info(entries: list, widths: list) -> torch.Tensor:
    """:func:`sorted_heads`' table of the entries, uploaded to their
    device: per entry, its chunk's offset, its group's first row in the
    entries' table of database indices, its last lane and its head's
    width, int64 ``[entries, 4]``.  The upload is from pageable memory,
    so it waits for the work queued before it on the stream: a span
    ``fetch.wait``, the host blocked on the device."""
    base, first = {}, 0
    for e in entries:
        if id(e.group) not in base:
            base[id(e.group)] = first
            first += len(e.group["ids"])
    rows = [[e.offset, base[id(e.group)], len(e.group["ids"]) - 1, w]
            for e, w in zip(entries, widths)]
    with profiling.span("fetch.wait"):
        return torch.tensor(rows, dtype=torch.int64, device=entries[0].counts.device)


def sorted_heads(entries: list, widths: list, info: torch.Tensor) -> torch.Tensor:
    """Every entry's counters and the heads of its hits, merged and sorted
    by (motif, position) on their device, as one int32 tensor for one
    read (:func:`unpack_heads` takes it apart): the counters ``[entries,
    4]``, then ``[3, sum(widths)]`` positions in the scanned sequence,
    database motif ids (-1 past the valid slots) and f32 bits, the valid
    slots first.  ``info`` is
    :func:`heads_info` of the same entries and widths.  The work on the
    device is the same few ops whatever the number of entries, and reads
    nothing, so a caller may record it into a CUDA graph."""
    device = info.device
    tables = {}
    for e in entries:
        tables.setdefault(id(e.group), e.group)
    total = sum(widths)
    entry = torch.repeat_interleave(torch.arange(len(entries), device=device), info[:, 3],
                                    output_size=total)
    counts = torch.stack([e.counts for e in entries])
    slot = torch.arange(total, device=device) - (torch.cumsum(info[:, 3], 0) - info[:, 3])[entry]
    head = torch.cat([e.packed[:, :w] for e, w in zip(entries, widths)], dim=1).to(torch.int64)
    # slots past an entry's n_kept hold anything: clamp their lanes
    lanes = torch.minimum(head[1].clamp_(min=0), info[entry, 2])
    ids = torch.cat([g["ids_dev"] for g in tables.values()])[info[entry, 1] + lanes]
    pos = head[0] + info[entry, 0]
    valid = slot < counts[entry, 2]
    ids = torch.where(valid, ids, -1)
    order = torch.argsort(torch.where(valid, (ids << 40) | pos, torch.iinfo(torch.int64).max))
    return torch.cat([counts.reshape(-1), torch.stack([pos[order], ids[order],
                                                       head[2][order]]).to(torch.int32)
                      .reshape(-1)])


def merge_sorted_heads(parts: list, sizes: list) -> torch.Tensor:
    """:func:`sorted_heads` of several devices' entries, each copied to
    one device, as one tensor of the same form: every part's counters in
    turn (``sizes`` entries each), then all their hits merged and sorted
    by (motif, position), the valid slots first.  A few ops on one
    device, whatever the number of parts."""
    counts = torch.cat([part[: 4 * n] for part, n in zip(parts, sizes)])
    hits = torch.cat([part[4 * n :].view(3, -1) for part, n in zip(parts, sizes)],
                     dim=1).to(torch.int64)
    key = torch.where(hits[1] >= 0, (hits[1] << 40) | hits[0], torch.iinfo(torch.int64).max)
    return torch.cat([counts, hits[:, torch.argsort(key)].to(torch.int32).reshape(-1)])


def unpack_heads(flat: np.ndarray, n: int) -> tuple:
    """``(counts int32 [n, 4], hits int32 [3, total])`` of a read of
    :func:`sorted_heads` of ``n`` entries; the counters are copied out of
    the read's buffer, the hits are a view of it."""
    return flat[: 4 * n].reshape(n, 4).copy(), flat[4 * n :].reshape(3, -1)


def read_sorted(entries: list, read=read_host, hints=None):
    """Every entry's counters and the heads of their hits, merged and
    sorted on the device by (motif, position), in one read: ``(counts
    int32 [entries, 4], hits int32 [3, total], widths)`` on the host,
    ``hits`` rows positions in the scanned sequence, database motif ids
    and f32 bits, the valid slots first.  An entry's head is its first
    ``widths[i]`` slots (:func:`head_widths` of ``hints``, a capacity
    key's last ``n_kept``); it holds every kept hit of the entry when
    ``n_kept <= widths[i]``.  The entries lie on one device, whose groups
    hold their ``ids_dev`` (:func:`sorted_heads`)."""
    widths = head_widths(entries, hints)
    flat = read(sorted_heads(entries, widths, heads_info(entries, widths)))
    return (*unpack_heads(flat, len(entries)), widths)


def settle_entries(entries: list, counts, widths, read=read_host, state=None, hints=None) -> list:
    """Re-run, at doubled capacities until they fit, the entries whose
    counters (from :func:`read_sorted`) overflowed, reading each re-run's
    counters; keep each capacity key's capacities in ``state`` (the
    largest any entry needed) and its largest ``n_kept`` in ``hints``
    (the last value halved first, so one heavy scan stops widening the
    heads).  Returns ``(entries, complete)``: the settled entries, and
    whether the heads read already held every kept hit of every entry."""
    state = {} if state is None else state
    hints = {} if hints is None else hints
    settled, kept, complete = [], {}, True
    with profiling.span("fetch.settle"):
        for e, c, w in zip(entries, counts, widths):
            while _overflowed(e, c):
                with profiling.span("fetch.rerun"):
                    e = e.rerun(ratchet(e.cap, int(c[0])),
                                ratchet(e.cap_hits, int(c[1])))._replace(offset=e.offset)
                    kernels.count_launch(RERUNS,
                                         "dense" if isinstance(e.key, tuple) else "group")
                    c = read(e.counts)
                complete = False
            old = state.get(e.key, (0, 0))
            state[e.key] = (max(old[0], e.cap), max(old[1], e.cap_hits))
            kept[e.key] = max(kept.get(e.key, 0), int(c[2]))
            complete = complete and int(c[2]) <= w
            settled.append(e)
        for key, n in kept.items():
            hints[key] = max(hints.get(key, 0) >> 1, n)
    return settled, complete


def fits(entries: list, counts, widths) -> bool:
    """Whether :func:`read_sorted`'s read holds every kept hit: no entry
    overflowed its capacities or keeps more hits than its head holds."""
    return not any(_overflowed(e, c) or int(c[2]) > w
                   for e, c, w in zip(entries, counts, widths))


def collect_device(entries: list, read=read_host, state=None, hints=None, first=None,
                   span=None):
    """Hit arrays ``(motif_ids int32, positions int64, scores float32)``,
    ordered by (motif, position), of dispatched entries on one device:
    one read (:func:`read_sorted`, or ``first``, its result) when every
    entry fits its capacities and its head; else the re-runs and one more
    read.  ``span``, a recording span, takes :func:`entry_counts` of the
    settled entries."""
    hints = {} if hints is None else hints
    counts, hits, widths = first or read_sorted(entries, read, hints)
    entries, complete = settle_entries(entries, counts, widths, read, state, hints)
    if not complete:
        counts, hits, _ = read_sorted(entries, read, hints)
    if span:
        span.add(**entry_counts(entries, counts))
    return _hit_arrays(hits[:, : int(counts[:, 2].sum())])


def entry_counts(entries: list, counts) -> dict:
    """The fetch's counts of settled entries, from their counters read on
    the host (``[candidates, pairs, kept, valid]`` rows): ``entries``,
    ``candidates``, ``pairs`` and ``kept``, and ``by_group``, the same
    per capacity key (a group's index; ``"dense"`` for every dense
    motif)."""
    names = ("entries", "candidates", "pairs", "kept")
    by_group = {}
    for e, c in zip(entries, counts):
        row = by_group.setdefault("dense" if isinstance(e.key, tuple) else e.key,
                                  dict.fromkeys(names, 0))
        for name, value in zip(names, (1, *c[:3])):
            row[name] += int(value)
    return {**{name: sum(row[name] for row in by_group.values()) for name in names},
            "by_group": by_group}


def _hit_arrays(hits):
    # copies: ``hits`` may be a view of a reader's buffer
    with profiling.span("fetch.hit_arrays"):
        return hits[1].copy(), hits[0].astype(np.int64), hits[2].view(np.float32).copy()


def merge_hits(parts: list):
    """One ``(motif_ids, positions, scores)`` ordered by (motif, position)
    from several such arrays (one per device)."""
    parts = [p for p in parts if len(p[0])]
    if not parts:
        return (np.zeros(0, np.int32), np.zeros(0, np.int64), np.zeros(0, np.float32))
    if len(parts) == 1:
        return parts[0]
    motif_ids, positions, scores = (np.concatenate(column) for column in zip(*parts))
    # (motif, position) is unique per hit; each part is sorted, so a stable
    # sort of the packed key merges a few sorted runs
    order = np.argsort((motif_ids.astype(np.int64) << 40) | positions, kind="stable")
    return motif_ids[order], positions[order], scores[order]


def collect_entries(entries: list, read=read_host, state=None, hints=None):
    """Hit arrays ``(motif_ids int32, positions int64, scores float32)`` of
    dispatched entries, ordered by (motif, position): :func:`collect_device`
    on each device (one read each in steady state), merged."""
    by_device = {}
    for e in entries:
        by_device.setdefault(e.counts.device, []).append(e)
    return merge_hits([collect_device(ents, read, state, hints)
                       for ents in by_device.values()])


def sorted_hits(parts):
    """Hit arrays ``(motif_ids int32, positions int64, scores float32)`` on
    the host, ordered by (motif, position), from :func:`scan_groups`'
    entries (read by :func:`collect_entries`) or from ``(positions, motif
    ids, scores)`` triples of tensors."""
    if parts and isinstance(parts[0], Entry):
        return collect_entries(parts)
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
        _group_tables(group, lengths)
        groups.append(group)
    return groups
