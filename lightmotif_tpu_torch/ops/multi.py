"""Multi-motif scanning: a whole motif group against a sequence at once.

Counterpart of :mod:`lightmotif_tpu.ops.multi`.  The host packers
(:func:`fine_discretize` to :func:`pack_dense_motif`) are numpy and
give the JAX package's arrays byte for byte; :func:`pack_motif_group`
adds the layouts the port's device stages read (``k3``, ``fine``,
``t_eff``).

The device stages (:func:`scan_multi_core`) are the torch version of
the JAX ``scan_multi_core`` on one segment:

1. K3 (:func:`.multi_kernel.prefilter_any8`): ``max_mo (sum16 - t16)``
   of every window start; ``>= 0`` marks a candidate;
2. candidates: one ``torch.nonzero``, exact, so there are no capacities
   and no retry;
3. phase C: the u16 test per (candidate, motif lane), ``sum16 - t16 >=
   0`` inside the lane's valid windows, as one one-hot matmul against
   the byte planes of ``d16`` (exact, see :func:`phase_c_filters`);
4. pairs: ``torch.nonzero`` of the phase-C mask, which lists them in
   ascending (position, motif lane) order -- the order the JAX bit-pack
   and lowest-set-bit extraction produce;
5. :func:`rescore_multi`: the exact f32 score of each pair, and the keep
   mask ``score >= threshold``.

The u16 test has no false negatives against the f32 threshold
(:func:`fine_discretize`), so the hits are the exact ones.
"""

from __future__ import annotations

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
    "scan_multi_core",
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


def pack_filters_k3(data16, t16):
    """The filters of the port's K3 (:func:`.multi_kernel.prefilter_any8`).

    ``data16``: ``[M, m, K]`` u16 cells; ``t16``: ``[M]`` u16 thresholds
    (65536 = never pass).  Lanes pad to :data:`.multi_kernel.
    BITS_PER_WORD` like the JAX filters.  Returns

    * ``table`` int32 ``[chunks, m, K, K3_LANES]``: ``table[c, j, s, l] =
      data16[c * K3_LANES + l, j, s]``, zero for padded lanes;
    * ``chunk_m`` int32 ``[chunks]``: one past the last row with a
      nonzero cell in the chunk (the kernel sums no row past it; those
      rows are zero, so no sum changes);
    * ``t_eff`` int32 ``[m_pad]``: ``clip(t16, 0, 65535)``, or ``2**26``
      for never-pass and padded lanes -- the JAX kernel's values exactly
      (``adj`` minus its byte-plane shift).
    """
    mcount, m, k = data16.shape
    bpw = multi_kernel.BITS_PER_WORD
    lanes = multi_kernel.K3_LANES
    m_pad = -(-mcount // bpw) * bpw
    d = np.zeros((m_pad, m, k), np.int32)
    d[:mcount] = data16
    table = np.ascontiguousarray(
        d.reshape(m_pad // lanes, lanes, m, k).transpose(0, 2, 3, 1))
    rows = (table != 0).any(axis=(2, 3))  # [chunks, m]
    chunk_m = np.where(rows.any(axis=1), m - np.argmax(rows[:, ::-1], axis=1), 0)
    tt = np.asarray(t16, np.int64)
    t_eff = np.full(m_pad, 1 << 26, np.int64)
    t_eff[:mcount] = np.where(tt > 65535, 1 << 26, np.clip(tt, 0, 65535))
    return table, chunk_m.astype(np.int32), t_eff.astype(np.int32)


def phase_c_filters(data16):
    """f32 ``[m * K, 2 * m_pad]`` byte planes of the phase-C matmul:
    column ``mo`` holds ``data16[mo] >> 8`` and column ``m_pad + mo``
    ``data16[mo] & 255``, row ``j * K + s``.

    One-hot windows times these planes give ``sum16 >> 8``-weighted and
    low-byte sums exactly at every ``torch.set_float32_matmul_precision``:
    the operands are 0/1 and integers below 256 (at most 8 significant
    bits; TF32 keeps 11, bf16 8), every product is exact, and every sum
    is an integer below ``m * 255 < 2**24``."""
    mcount, m, k = data16.shape
    bpw = multi_kernel.BITS_PER_WORD
    m_pad = -(-mcount // bpw) * bpw
    out = np.zeros((m * k, 2 * m_pad), np.float32)
    flat = np.asarray(data16).reshape(mcount, m * k).T
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
    (:func:`phase_c_filters`) and ``t_eff`` (``k3``'s thresholds).
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
    k3 = pack_filters_k3(d16, t16)
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
        "k3": k3,
        "fine": phase_c_filters(d16),
        "t_eff": k3[2],
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
    """The tensors of a packed group that the device stages read."""
    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return {
        "k3": tuple(dev(a) for a in g["k3"]),
        "fine": dev(g["fine"]),
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
            t_eff: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """``sum16 - t_eff`` of every (candidate, motif lane) as int32
    ``[n, m_pad]``, exactly (see :func:`phase_c_filters`)."""
    n = positions.shape[0]
    m_pad = t_eff.shape[0]
    sym = _windows(chunk, positions, m, k)
    onehot = torch.zeros((n, m * k), dtype=torch.float32, device=chunk.device)
    onehot.scatter_(1, sym + torch.arange(m, device=chunk.device) * k, 1.0)
    planes = (onehot @ fine).to(torch.int32)  # [n, 2 * m_pad]
    return 256 * planes[:, :m_pad] + planes[:, m_pad:] - t_eff


def phase_c_pairs(chunk: torch.Tensor, cand: torch.Tensor, n_valid: torch.Tensor,
                  group: dict, k: int):
    """(position, motif lane) pairs that pass the u16 test inside the
    lane's valid windows, in ascending (position, lane) order."""
    m_pad = group["t_eff"].shape[0]
    blk = max(1, PHASE_C_ELEMS // (2 * m_pad))
    rows, lanes = [], []
    for b0 in range(0, cand.shape[0], blk):
        pos = cand[b0 : b0 + blk]
        part = phase_c(chunk, pos, group["fine"], group["t_eff"],
                       group["m_max"], k)
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


def scan_multi_core(chunk: torch.Tensor, n_valid: torch.Tensor, group: dict,
                    k: int, mark=None):
    """Hits of one motif group in one segment.

    ``chunk``: uint8 ranks of the segment's window starts plus the
    group's ``m - 1`` halo; ``n_valid``: int64 ``[m_pad]`` window starts
    of each lane that this segment owns (0 for padded lanes).  Returns
    ``(positions, lanes, scores)`` of the kept hits in ascending
    (position, lane) order: positions relative to the chunk, lanes
    within the group, f32 scores.

    ``mark``, a timing hook, is called once each stage's work is queued
    with the stage's name and the count it produced: ``("k3", window
    starts)``, ``("candidates", n)``, ``("phase_c", pairs)``,
    ``("rescore", kept hits)``.
    """
    mark = mark or _no_mark
    maxv = multi_kernel.prefilter_any8(chunk, *group["k3"])
    mark("k3", maxv.shape[0])
    cand = candidates(maxv)
    mark("candidates", cand.shape[0])
    positions, lanes = phase_c_pairs(chunk, cand, n_valid, group, k)
    mark("phase_c", positions.shape[0])
    scores = rescore_multi(chunk, group["pssm"], positions, lanes)
    keep = scores >= group["th"][lanes]
    positions, lanes, scores = positions[keep], lanes[keep], scores[keep]
    mark("rescore", positions.shape[0])
    return positions, lanes, scores
