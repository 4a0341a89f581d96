"""The plain reference of a database scan: scoring matrices, thresholds
and every window's score, worked out again from the count matrices.

It follows lightmotif's published description (``pwm/mod.rs``,
``pwm/dist.rs``) with plain NumPy and PyTorch, and imports nothing of the
program:

* the matrix chain, in float32 as published: counts plus the
  pseudocount on every base (0 on the wildcard), divided by the row's
  sequential sum, divided by the background, then ``log2`` (the wildcard,
  whose background is 0, scores ``-inf``); the reverse strand reverses
  the rows and swaps each base for its complement;
* the threshold at a p-value, from the score distribution of MEME's
  method: the matrix rescaled to integers over :data:`CDF_RANGE` steps a row,
  the distribution of a random window's integer score by dynamic
  programming (in float64, on the device, every motif at once), and the
  least integer score whose survival is under ``p``, scaled back in
  float32;
* every window's score as a float64 matrix product of the one-hot
  windows with the matrices, in blocks of window starts; a window that
  holds the wildcard scores about ``NEG``;
* a record set joined with wildcard separators of its own
  (:func:`join_records`), so that no window of one record reaches the
  next.

``dtype=torch.bfloat16`` computes the chain, the thresholds' matrix and
the window sums in bfloat16: the control that the comparison has to fail.
"""

from __future__ import annotations

import numpy as np
import torch

#: A wildcard's weight in a window sum: finite, so that the one-hot
#: product has no ``0 * inf``, and far below any threshold.
NEG = -1e30


def complement_permutation(alphabet: str, complement: str) -> np.ndarray:
    return np.asarray([alphabet.index(c) for c in complement])


def scoring_matrices(counts: list, pseudocount: float, background: np.ndarray,
                     dtype=torch.float32) -> list:
    """Forward strands' scoring matrices (float32 arrays; bfloat16 values
    for the control), from ``uint32 [m, k]`` counts; ``background`` has a
    0 at the wildcard."""
    k = background.size
    rows = np.concatenate(counts).astype(np.float32)
    pseudo = np.where(background > 0, pseudocount, 0.0).astype(np.float32)
    if dtype == torch.float32:
        dst = rows + pseudo
        total = dst[:, 0].copy()
        for a in range(1, k):  # the published row sum is sequential
            total = total + dst[:, a]
        freq = dst / total[:, None]
        bg = background.astype(np.float32)
        with np.errstate(divide="ignore"):
            weight = np.where(bg > 0, freq / np.where(bg > 0, bg, 1), np.float32(0))
            score = np.log2(weight.astype(np.float32), dtype=np.float32)
    else:
        dst = torch.from_numpy(rows).to(dtype) + torch.from_numpy(pseudo).to(dtype)
        total = dst[:, 0].clone()
        for a in range(1, k):
            total = total + dst[:, a]
        freq = dst / total[:, None]
        bg = torch.from_numpy(background.astype(np.float32)).to(dtype)
        weight = torch.where(bg > 0, freq / torch.where(bg > 0, bg, 1), 0)
        score = torch.log2(weight).float().numpy()
    lengths = [c.shape[0] for c in counts]
    return np.split(score, np.cumsum(lengths)[:-1])


def reverse_complements(matrices: list, perm: np.ndarray) -> list:
    return [np.ascontiguousarray(w[::-1][:, perm]) for w in matrices]


#: Integer steps a matrix row is rescaled to (MEME's, ``dist.rs``).
CDF_RANGE = 1000


def thresholds(matrices: list, background: np.ndarray, pvalue: float, device) -> np.ndarray:
    """float32 threshold of each matrix at ``pvalue`` (0 < p < 1)."""
    if not 0.0 < pvalue < 1.0:
        raise ValueError("the p-value must lie in (0, 1)")
    k = background.size
    rows = np.asarray([w.shape[0] for w in matrices])
    m_max = int(rows.max())
    size = m_max * CDF_RANGE + 1
    scaled = np.full((len(matrices), m_max, k), -1, np.int64)  # -1: a skipped cell
    scales, offsets = np.empty(len(matrices)), np.empty(len(matrices))
    for b, w in enumerate(matrices):
        finite = w[np.isfinite(w)]
        small, large = float(finite.min()), float(finite.max())
        if small == large:
            small = large - 1.0
        offsets[b] = np.floor(small)
        scales[b] = np.floor(CDF_RANGE / (large - offsets[b]))
        with np.errstate(invalid="ignore"):
            cells = np.round((w.astype(np.float64) - offsets[b]) * scales[b])
        scaled[b, : w.shape[0]] = np.where(np.isfinite(cells), cells, -1)
    cells = torch.from_numpy(scaled).to(device)
    bg = [float(x) for x in background.astype(np.float64)]
    live = torch.from_numpy(rows).to(device)
    pdf = torch.zeros(len(matrices), size, dtype=torch.float64, device=device)
    pdf[:, 0] = 1.0
    t = torch.arange(size, device=device)
    for i in range(m_max):
        reach = i * CDF_RANGE
        new = torch.zeros_like(pdf)
        for a in range(k):
            s = cells[:, i, a : a + 1]
            src = t[None, :] - s
            ok = (s >= 0) & (src >= 0) & (src <= reach)
            got = torch.gather(pdf, 1, src.clamp(0, size - 1))
            new = new + torch.where(ok, got, 0.0) * bg[a]
        pdf = torch.where((live > i)[:, None], new, pdf)
    sf = torch.flip(torch.cumsum(torch.flip(pdf, [1]), 1), [1]).clamp(max=1.0)
    idx = (sf >= pvalue).sum(dim=1).cpu().numpy()
    return np.asarray([np.float32(np.float32(i) / np.float32(sc) + np.float32(m * off))
                       for i, sc, m, off in zip(idx, scales, rows, offsets.astype(np.int64))],
                      np.float32)


#: Matrices of this length or longer share one group of window sums (the
#: database has few of each such length).
MERGE_FROM = 21

#: Bytes of a block's one-hot windows and sums together: a group with
#: wide windows (protein) or many matrices takes fewer window starts a
#: block than ``block``.
BLOCK_BYTES = 20 << 30


def length_groups(lengths: np.ndarray) -> list:
    """Matrix ids grouped for the window sums: one group per length below
    :data:`MERGE_FROM`, one for all the longer ones."""
    keys = np.minimum(lengths, MERGE_FROM)
    return [np.flatnonzero(keys == key) for key in np.unique(keys)]


class Windows:
    """Every window's score of a set of matrices over one sequence, in
    blocks of ``block`` window starts, as ``dtype`` (float64, or
    bfloat16 for the control)."""

    def __init__(self, matrices: list, k: int, wildcard: int, device,
                 dtype=torch.float64, block: int = 1 << 22):
        self.k, self.wildcard, self.device = k, wildcard, torch.device(device)
        self.dtype, self.block = dtype, int(block)
        self.lengths = np.asarray([w.shape[0] for w in matrices])
        self.groups = []
        for ids in length_groups(self.lengths):
            m_pad = int(self.lengths[ids].max())
            table = np.zeros((len(ids), m_pad, k), np.float64)
            for c, i in enumerate(ids):
                w = matrices[i].astype(np.float64)
                table[c, : w.shape[0]] = np.where(np.isfinite(w), w, NEG)
            table = torch.from_numpy(table.reshape(len(ids), m_pad * k).T.copy())
            self.groups.append((ids, m_pad, table.to(self.device, self.dtype)))

    def sums(self, codes: torch.Tensor):
        """Yield ``(group ids, first window start, sums [rows, ids])`` over
        ``codes`` (uint8 ranks on the device): row ``r`` is the window
        starting at ``first + r``; windows past the end hold the wildcard."""
        n = codes.shape[0]
        m_max = max(m for _, m, _ in self.groups)
        padded = torch.cat([codes, torch.full((m_max,), self.wildcard, dtype=codes.dtype,
                                              device=codes.device)])
        item = torch.tensor([], dtype=self.dtype).element_size()
        for ids, m_pad, table in self.groups:
            cols = self.k * torch.arange(m_pad, device=self.device)
            block = min(self.block, max(1, BLOCK_BYTES // ((m_pad * self.k + len(ids)) * item)))
            for start in range(0, n, block):
                rows = min(block, n - start)
                win = padded[start : start + rows + m_pad - 1].unfold(0, m_pad, 1)
                onehot = torch.zeros(rows, m_pad * self.k, dtype=self.dtype, device=self.device)
                onehot.scatter_(1, win.long() + cols, 1.0)
                yield ids, start, onehot @ table
                del onehot


def join_records(records: list, gap: int, wildcard: int) -> tuple:
    """``(codes, offsets, lengths)``: the records (``uint8`` rank
    arrays) one after another, each followed by ``gap`` wildcards, and
    where each starts and how long it is."""
    lengths = np.asarray([len(r) for r in records], np.int64)
    offsets = np.concatenate([[0], np.cumsum(lengths + gap)[:-1]]).astype(np.int64)
    codes = np.full(int((lengths + gap).sum()), wildcard, np.uint8)
    for r, at in zip(records, offsets):
        codes[at : at + len(r)] = r
    return codes, offsets, lengths


def scan(windows: Windows, codes: torch.Tensor, thresholds: np.ndarray) -> tuple:
    """The control's scan: ``(motif ids, positions, scores)`` of every
    window at or above its threshold, the sums and thresholds in
    ``windows.dtype``, in (motif, position) order."""
    ids_out, pos_out, sc_out = [], [], []
    t_all = torch.from_numpy(thresholds).to(windows.device, windows.dtype)
    for ids, start, sums in windows.sums(codes):
        r, c = torch.nonzero(sums >= t_all[torch.from_numpy(ids).to(windows.device)],
                             as_tuple=True)
        ids_out.append(torch.from_numpy(ids).to(windows.device)[c])
        pos_out.append(r + start)
        sc_out.append(sums[r, c].float())
    ids = torch.cat(ids_out).cpu().numpy().astype(np.int32)
    pos = torch.cat(pos_out).cpu().numpy()
    sc = torch.cat(sc_out).cpu().numpy()
    order = np.lexsort((pos, ids))
    return ids[order], pos[order], sc[order]
