"""Plain PyTorch versions of the scan primitives.

Counterpart of :mod:`lightmotif_tpu.ops.xla_ops`.  These are the
reference versions of the CUDA kernels in ``csrc/score.cu``: the kernel
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

:func:`prefilter_any8` is the plain version of the multi-motif
prefilter K3 (``csrc/prefilter.cu``).
"""

from __future__ import annotations

import torch

__all__ = [
    "score_f32",
    "score_u8",
    "prefilter_any8",
    "max_last",
    "argmax_last",
    "compact_mask",
    "rescore_positions",
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


def prefilter_any8(seq: torch.Tensor, table: torch.Tensor, chunk_m: torch.Tensor,
                   t_eff: torch.Tensor) -> torch.Tensor:
    """``max_mo (sum_j d16[mo, j, s[p+j]] - t_eff[mo])`` of every window
    start as int32 ``[Lp]``.

    ``table``: int32 ``[chunks, m, K, lanes]`` with ``table[c, j, s, l]
    = d16[c * lanes + l, j, s]``; ``t_eff``: int32 ``[chunks * lanes]``.
    Every row ``j < m`` is summed: ``chunk_m`` is the CUDA kernel's loop
    bound, and the rows past it are zero, so it changes no sum and is
    not read here.  Integer sums are exact in any order.
    """
    n_chunks, m, k, lanes = table.shape
    m_pad = n_chunks * lanes
    d = table.permute(1, 2, 0, 3).reshape(m, k, m_pad)  # d[j, s, mo]
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


def max_last(scores: torch.Tensor) -> torch.Tensor:
    return scores.max()


def argmax_last(scores: torch.Tensor) -> torch.Tensor:
    """Index of the maximum; the *last* occurrence wins (the reference's
    ``>=`` tie rule)."""
    top = scores.max()
    pos = torch.arange(scores.shape[0], device=scores.device)
    return torch.where(scores == top, pos, -1).max()


def compact_mask(mask: torch.Tensor) -> torch.Tensor:
    """Ascending indices of the set entries of a boolean mask; the exact
    count is their number."""
    return torch.nonzero(mask).flatten()


def rescore_positions(seq: torch.Tensor, pssm: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    """Exact f32 scores of selected window starts (sequential j-order
    adds, as ``ScoringMatrix.score_position``).  Every window must lie
    inside ``seq``."""
    m = pssm.shape[0]
    acc = torch.zeros(positions.shape, dtype=torch.float32, device=seq.device)
    for j in range(m):
        acc = acc + pssm[j][seq[positions + j].to(torch.int64)]
    return acc


def scan_segment(chunk: torch.Tensor, n_here: int, dm: torch.Tensor,
                 pssm: torch.Tensor, t_scaled: int, threshold: float):
    """Two-pass scan of one segment.

    ``chunk`` holds the segment's ``n_here`` window starts plus the
    (m-1)-position halo.  The discrete first pass (the scoring kernel in
    discrete mode) selects the candidates ``>= t_scaled``; they are
    rescored exactly and kept where the f32 score is ``>= threshold``.
    Returns ``(positions, scores)`` of the kept hits, in ascending
    position order.
    """
    from . import kernels

    dscores = kernels.score_u8(chunk, dm, n_here)
    idx = compact_mask(dscores >= t_scaled)
    fscores = rescore_positions(chunk, pssm, idx)
    keep = fscores >= torch.tensor(threshold, dtype=torch.float32)
    return idx[keep], fscores[keep]
