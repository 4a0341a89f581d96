"""Plain PyTorch versions of the scan primitives.

Counterpart of :mod:`lightmotif_tpu.ops.xla_ops`.  These are the
reference versions of the CUDA kernels in ``csrc/``: the kernel
wrappers in :mod:`.kernels` run them for tensors on the CPU, the CPU
tests hold them to the JAX package, and ``chip_smoke.py`` holds the
kernels to them on the card.

Arithmetic contracts, as in the JAX package:

* an f32 score is the sequential ascending-j sum of the motif rows,
  written as an explicit loop of elementwise adds (no ``torch.sum`` and
  no matmul over j, which could reassociate);
* a discrete score is the int32 sum clamped to 255, which equals the
  reference's stepwise-saturating u8 sum;
* the last maximum wins ties.

Sequences are flat ``uint8`` rank tensors.  A window that runs past the
end of the sequence reads the wildcard (rank ``K - 1``), and so does any
rank ``>= K``.

:func:`scan_segment` is the plain version of the Scanner's segment
kernel (``csrc/scan.cu``): the discrete pass (:func:`score_u8`), then
:func:`scan_compact` (the compaction, rescore and keep) and
:func:`segment_best`.

:func:`prefilter_any8`, :func:`prefilter_any` and :func:`prefilter_any16`
are the plain versions of the multi-motif prefilters K3, K4 and K5
(``csrc/prefilter.cu``): one function of their byte planes, as the
kernel is one kernel (see :mod:`.multi_kernel`).
"""

from __future__ import annotations

import torch

__all__ = [
    "score_f32",
    "score_u8",
    "plane_cells",
    "prefilter_any8",
    "prefilter_any",
    "prefilter_any16",
    "max_last",
    "argmax_last",
    "rescore_positions",
    "scan_compact",
    "segment_best",
    "scan_segment",
]


def _window_ranks(seq: torch.Tensor, m: int, k: int) -> torch.Tensor:
    """int64 ranks ``[Lp + m - 1]``: the sequence plus an (m-1) wildcard
    tail, with out-of-range ranks read as the wildcard."""
    s = seq.to(torch.int64).clamp(max=k - 1)
    tail = torch.full((m - 1,), k - 1, dtype=torch.int64, device=seq.device)
    return torch.cat([s, tail])


def score_f32(seq: torch.Tensor, pssm: torch.Tensor, n_scores: int) -> torch.Tensor:
    """Exact f32 score of every window start.

    ``seq``: uint8 ``[Lp]``; ``pssm``: float32 ``[m, K]``.  Returns
    float32 ``[Lp]`` with ``-inf`` at positions ``>= n_scores``.
    """
    m, k = pssm.shape
    lp = seq.shape[0]
    s = _window_ranks(seq, m, k)
    acc = pssm[0][s[:lp]]
    for j in range(1, m):
        acc = acc + pssm[j][s[j : j + lp]]
    pos = torch.arange(lp, device=seq.device)
    return torch.where(pos < n_scores, acc, float("-inf"))


def score_u8(seq: torch.Tensor, dm: torch.Tensor, n_scores: int) -> torch.Tensor:
    """Discrete scores ``min(sum_j dm[j, s[p+j]], 255)`` as int32.

    ``dm``: uint8 ``[m, K]``.  Returns int32 ``[Lp]`` with ``-1`` at
    positions ``>= n_scores``.
    """
    m, k = dm.shape
    lp = seq.shape[0]
    s = _window_ranks(seq, m, k)
    table = dm.to(torch.int32)
    acc = table[0][s[:lp]]
    for j in range(1, m):
        acc = acc + table[j][s[j : j + lp]]
    acc = torch.clamp(acc, max=255)
    pos = torch.arange(lp, device=seq.device)
    return torch.where(pos < n_scores, acc, -1)


#: Elements of the ``[positions, lanes]`` int32 block of
#: :func:`prefilter_any8` (64 MiB).
_K3_BLOCK_ELEMS = 1 << 24


def plane_cells(planes: torch.Tensor) -> torch.Tensor:
    """The cells of the prefilters' byte planes: int32 ``[lanes, rows, K]``
    with ``cells[c * L + l, j, s] = sum_q 256**q planes[q, c, l, j, s]``
    (``planes``: uint8 ``[P, chunks, L, rows, K]``)."""
    n_planes, chunks, lanes, rows, k = planes.shape
    cells = torch.zeros((chunks, lanes, rows, k), dtype=torch.int64, device=planes.device)
    for q in range(n_planes):
        cells += planes[q].to(torch.int64) << (8 * q)
    return cells.reshape(chunks * lanes, rows, k).to(torch.int32)


def prefilter_any8(seq: torch.Tensor, planes: torch.Tensor, chunk_m: torch.Tensor,
                   t_eff: torch.Tensor) -> torch.Tensor:
    """``max_mo (sum_j cell[mo, j, s[p+j]] - t_eff[mo])`` of every window
    start as int32 ``[Lp]``, with the cells of :func:`plane_cells`.

    ``planes``: uint8 ``[P, chunks, lanes, rows, K]``; ``t_eff``: int32
    ``[chunks * lanes]``.  Every row ``j < rows`` is summed: ``chunk_m``
    is the CUDA kernel's k-step bound, and the rows past it are zero, so
    it changes no sum and is not read here.  Integer sums are exact in
    any order.
    """
    cells = plane_cells(planes)
    m_pad, m, k = cells.shape
    d = cells.permute(1, 2, 0).contiguous()  # d[j, s, mo]
    lp = seq.shape[0]
    s = _window_ranks(seq, m, k)
    out = torch.empty(lp, dtype=torch.int32, device=seq.device)
    blk = max(1, _K3_BLOCK_ELEMS // m_pad)
    for p0 in range(0, lp, blk):
        p1 = min(p0 + blk, lp)
        acc = d[0][s[p0:p1]]  # [n, m_pad]
        for j in range(1, m):
            acc += d[j][s[p0 + j : p1 + j]]
        out[p0:p1] = (acc - t_eff).amax(dim=1)
    return out


def prefilter_any(seq: torch.Tensor, planes: torch.Tensor, chunk_m: torch.Tensor,
                  t_eff: torch.Tensor) -> torch.Tensor:
    """K4's plain version: :func:`prefilter_any8` of the u8 plane."""
    return prefilter_any8(seq, planes, chunk_m, t_eff)


def prefilter_any16(seq: torch.Tensor, planes: torch.Tensor, chunk_m: torch.Tensor,
                    t_eff: torch.Tensor) -> torch.Tensor:
    """K5's plain version: :func:`prefilter_any8` of the K5 planes."""
    return prefilter_any8(seq, planes, chunk_m, t_eff)


def max_last(scores: torch.Tensor) -> torch.Tensor:
    return scores.max()


def argmax_last(scores: torch.Tensor) -> torch.Tensor:
    """Index of the maximum; the *last* occurrence wins (the reference's
    ``>=`` tie rule)."""
    top = scores.max()
    pos = torch.arange(scores.shape[0], device=scores.device)
    return torch.where(scores == top, pos, -1).max()


def rescore_positions(seq: torch.Tensor, pssm: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    """Exact f32 scores of selected window starts: from +0.0, the
    sequential ascending-j adds of ``pssm[j, s[p + j]]``, as the JAX
    package's ``rescore_positions`` (so a sum of -0.0 terms is +0.0).
    Ranks ``>= K`` read the wildcard.  Every window must lie inside
    ``seq``."""
    m, k = pssm.shape
    rows = torch.arange(m, device=seq.device)
    terms = pssm[rows, seq[positions[:, None] + rows].to(torch.int64).clamp_(max=k - 1)]
    acc = torch.zeros(positions.shape, dtype=torch.float32, device=seq.device)
    for j in range(m):
        acc = acc + terms[:, j]
    return acc


def scan_compact(scores: torch.Tensor, seq: torch.Tensor, pssm: torch.Tensor, n_here: int,
                 t_scaled: int, threshold: float, cap: int):
    """The fixed-capacity compaction, exact rescore and keep of one
    segment, given its discrete scores, with no read of the device: the
    second half of :func:`scan_segment`.

    ``scores``: int32 ``[>= n_here]`` (K2's; only the first ``n_here``
    are read); ``seq``: uint8, the segment's ``n_here`` window starts and
    their ``m - 1`` halo; ``pssm``: f32 ``[m, K]``.  The candidates are
    the window starts with ``score >= t_scaled``; the first ``cap`` of
    them in ascending order are rescored (:func:`rescore_positions`) and
    kept where the f32 score is ``>= threshold`` (as an f32).

    Returns ``(counts, packed)``: ``counts`` int32 ``[3]`` = ``[exact
    candidate count, n_kept, valid]`` (``n_kept`` among the first ``cap``
    candidates; ``valid`` is always 1, the compaction being complete at
    any density); ``packed`` int32 ``[2, cap]``, the kept hits
    front-compacted in ascending position order, as positions and f32
    bits.  Slots past ``n_kept`` hold zeros here and anything in the
    kernel: callers read ``packed[:, :n_kept]``.  The counterpart of the
    JAX ``scan_segment`` after its discrete pass (``dense=True``).
    """
    cand = scores[:n_here] >= t_scaled
    # no more than n_here candidates: a short segment rescores only its own
    idx = torch.nonzero_static(cand, size=min(cap, n_here), fill_value=n_here).flatten()
    live = idx < n_here
    fscores = rescore_positions(seq, pssm, torch.where(live, idx, 0))
    threshold = torch.tensor(threshold, dtype=torch.float32)
    keep = live & (fscores >= threshold)
    # each kept hit's slot; the others land in a dump slot past the end
    slot = torch.where(keep, torch.cumsum(keep, 0) - 1, cap)
    packed = torch.zeros((2, cap + 1), dtype=torch.int32, device=scores.device)
    packed[0].scatter_(0, slot, idx.to(torch.int32))
    packed[1].scatter_(0, slot, fscores.view(torch.int32))
    counts = torch.stack([cand.sum().clamp(max=2**31 - 1), keep.sum(),
                          torch.ones((), dtype=torch.int64, device=scores.device)])
    return counts.to(torch.int32), packed[:, :cap]


def segment_best(counts: torch.Tensor, packed: torch.Tensor) -> torch.Tensor:
    """The best of a segment's kept hits ``packed[:, :counts[1]]`` as
    int32 ``[2]``: its f32 bits and its position, the largest score and,
    among equal scores, the larger position (the reference's last-max
    rule, ``pli/mod.rs:146``); ``-inf`` bits and -1 when none is kept.
    No read of the device."""
    valid = torch.arange(packed.shape[1], device=packed.device) < counts[1]
    scores = torch.where(valid, packed[1].view(torch.float32), float("-inf"))
    top = scores.max()
    position = torch.where(valid & (scores == top), packed[0], -1).max()
    return torch.stack([top.reshape(1).view(torch.int32)[0], position.to(torch.int32)])


def scan_segment(chunk: torch.Tensor, n_here: int, dm: torch.Tensor, pssm: torch.Tensor,
                 t_scaled: int, threshold: float, cap: int):
    """Two-pass scan of one segment at a fixed capacity, all plain: the
    discrete scores (:func:`score_u8`), :func:`scan_compact`, then
    :func:`segment_best`.  The counterpart of the JAX
    ``xla_ops.scan_segment`` (``dense=True``); ``chunk`` holds the
    segment's ``n_here`` window starts plus the (m-1)-position halo.
    Returns ``(counts int32 [3], packed int32 [2, cap], best int32 [2])``,
    with no read of the device."""
    counts, packed = scan_compact(score_u8(chunk, dm, n_here), chunk, pssm, n_here, t_scaled,
                                  threshold, cap)
    return counts, packed, segment_best(counts, packed)
