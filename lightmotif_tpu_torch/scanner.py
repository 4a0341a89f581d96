"""Two-pass thresholded scanner.

Counterpart of :mod:`lightmotif_tpu.scanner` (``Scanner`` and its
helpers; ``MultiScanner`` is not in this package yet).  Each segment of
the sequence runs :func:`~.ops.torch_ops.scan_segment`:

1. discrete scores of every window start (the scoring kernel in
   discrete mode), an over-estimate of the f32 score, like the
   reference's u8 matrix;
2. exact compaction of the candidates at or above the scaled threshold;
3. exact f32 rescore of the candidates (sequential-order adds);
4. the final f32 threshold mask.

Segments carry an (m-1)-position halo -- the same overlap rule as the
reference's wrap rows (``seq.rs:369-381``) -- so scratch memory stays
bounded on long sequences.  Hits come out sorted by position.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .matrix import ScoringMatrix
from .ops import torch_ops
from .ops.pipeline import DeviceSequence, as_device_seq, resolve_device

__all__ = ["Hit", "Scanner"]

#: Window starts per segment.  It bounds the scan's scratch memory
#: (about 14 bytes per window start: the int32 discrete scores, the
#: candidate mask and the halo-padded ranks); a bacterial genome is
#: one segment.
DEFAULT_SEGMENT = 1 << 24

#: Kept for API parity with the JAX package, whose compaction works in
#: fixed-capacity buffers.  Compaction here is exact, so it is unused.
DEFAULT_CAPACITY = 1 << 16


@functools.total_ordering
class Hit:
    """A scored position (reference ``scan.rs:53-92``): ordered by
    (score, position)."""

    __slots__ = ("position", "score")

    def __init__(self, position: int, score: float):
        if np.isnan(score):
            raise ValueError("hit score cannot be NaN")
        self.position = int(position)
        self.score = float(score)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Hit)
            and other.position == self.position
            and other.score == self.score
        )

    def __lt__(self, other) -> bool:
        if self.score != other.score:
            return self.score < other.score
        return self.position < other.position

    def __repr__(self) -> str:  # pragma: no cover
        return f"Hit(position={self.position}, score={self.score})"


def _seq_ranks(seq) -> np.ndarray:
    from .sequence import EncodedSequence, StripedSequence

    if isinstance(seq, StripedSequence):
        seq = seq.unstripe()
    if isinstance(seq, EncodedSequence):
        return np.asarray(seq.data)
    if isinstance(seq, DeviceSequence):
        return seq.data.cpu().numpy()[: seq.length]
    raise TypeError(f"cannot extract symbols from {type(seq).__name__}")


def _reference_max(pssm, dm, seq, threshold: float,
                   lanes: int = 32, block_size: int = 256):
    """Host replay of the reference's ``Scanner::max`` rising-cutoff
    algorithm (``scan.rs:200-249``), bit-faithful to the AVX2 layout.

    Reproduced quirks:

    - the discrete cutoff starts at ``scale(threshold)`` and rises to
      the *quantized* score of each accepted candidate (``scan.rs:236``),
      so later candidates with a higher exact score but lower quantized
      score can be skipped;
    - candidates are visited in striped order (row within block, then
      lane; position = lane * rows + row) because acceptance depends on
      visit order once the cutoff starts rising;
    - unlike ``Scanner::next`` (``scan.rs:183``), no ``index + m <=
      len`` mask is applied, so default-symbol padding windows past the
      sequence end are scored and can be returned;
    - the first accepted candidate does not raise the cutoff
      (``scan.rs:244-246`` sets ``best`` without ``best_discrete``).
    """
    ranks = _seq_ranks(seq)
    m = len(pssm)
    L = int(ranks.shape[0])
    if L == 0 or m == 0:
        return None
    rows = -(-L // lanes)  # ceil: striped row count (pli/mod.rs:183)
    n_cells = rows * lanes
    default_idx = pssm.alphabet.default_index
    ext = np.full(n_cells + m, default_idx, dtype=np.int64)
    ext[:L] = ranks

    # u8 scores of every striped cell: stepwise saturating adds equal
    # one final clamp because the addends are non-negative
    dmat = np.asarray(dm.data, dtype=np.uint32)
    acc = np.zeros(n_cells, dtype=np.uint32)
    for j in range(m):
        acc += dmat[j][ext[j : j + n_cells]]
    dall = np.minimum(acc, 255)
    # grid[r, c] = dall[c * rows + r]
    grid = dall.reshape(lanes, rows).T

    pmat = np.asarray(pssm.data, dtype=np.float32)

    best = None  # (index, score)
    best_d = int(dm.scale(threshold))
    for row0 in range(0, rows, block_size):
        blk = grid[row0 : min(row0 + block_size, rows)]
        if int(blk.max(initial=0)) < best_d:
            continue
        cand = np.argwhere(blk >= best_d)  # row-major visit order
        if cand.shape[0] == 0:
            continue
        # Exact rescore of the block's candidate superset, vectorized
        # over candidates with elementwise f32 adds in ascending j (the
        # same IEEE operations as a scalar per-candidate loop).  The
        # cutoff can rise while the block is replayed, so this may score
        # candidates the scalar loop would skip; the acceptance replay
        # below still skips them.
        idx_arr = (cand[:, 1].astype(np.int64) * rows
                   + row0 + cand[:, 0])
        acc = np.zeros(idx_arr.shape[0], dtype=np.float32)
        for j in range(m):
            acc = acc + pmat[j, ext[idx_arr + j]]
        d_arr = blk[cand[:, 0], cand[:, 1]]
        for d, index, score in zip(
                d_arr.tolist(), idx_arr.tolist(), acc.tolist()):
            if d < best_d:
                continue
            if best is None:
                best = (index, score)
            elif score > best[1] or (score == best[1] and index > best[0]):
                best = (index, score)
                best_d = d
    return Hit(best[0], best[1]) if best is not None else None


class Scanner:
    """Iterator over hits of a PSSM in a sequence above a threshold."""

    def __init__(
        self,
        pssm: ScoringMatrix,
        seq,
        threshold: float = 0.0,
        block_size: int = DEFAULT_SEGMENT,
        capacity: int = DEFAULT_CAPACITY,
        device=None,
    ):
        self.pssm = pssm
        self.dm = pssm.to_discrete()
        self.seq = seq
        self.threshold = float(threshold)
        self.block_size = int(block_size)
        self.capacity = int(capacity)
        self.device = resolve_device(device)
        self._dseq = as_device_seq(seq, self.device)

    def _scan_segments(self, t_scaled: int, threshold: float):
        """Yield (positions, scores) numpy arrays of the kept hits of
        each segment, in ascending position order."""
        m = len(self.pssm)
        n_total = max(self._dseq.length - m + 1, 0)
        if n_total == 0:
            return
        if self.block_size < 1:
            raise ValueError("block_size must be positive")
        pssm_dev = torch.as_tensor(
            np.ascontiguousarray(self.pssm.data, dtype=np.float32),
            device=self.device)
        dm_dev = torch.as_tensor(
            np.ascontiguousarray(self.dm.data, dtype=np.uint8),
            device=self.device)
        data = self._dseq.data
        for off in range(0, n_total, self.block_size):
            n_here = min(self.block_size, n_total - off)
            chunk = data[off : off + n_here + m - 1]
            positions, scores = torch_ops.scan_segment(
                chunk, n_here, dm_dev, pssm_dev, t_scaled, threshold)
            if positions.numel():
                yield positions.cpu().numpy() + off, scores.cpu().numpy()

    def __iter__(self):
        t_scaled = int(self.dm.scale(self.threshold))
        for positions, scores in self._scan_segments(t_scaled, self.threshold):
            for p, s in zip(positions.tolist(), scores.tolist()):
                yield Hit(p, s)

    def collect(self) -> list:
        return list(self)

    def max(self, mode: str = "exact"):
        """Best hit among the discrete candidates; ties resolve to the
        larger position (``scan.rs:200-249``).

        Parity note: like the reference, the returned hit's exact f32
        score may be *below* the threshold -- candidacy is decided by
        the over-estimating discrete filter, and the best exact score
        among candidates wins.

        ``mode="exact"`` (default) keeps the discrete cutoff at
        ``scale(threshold)``, so it evaluates a superset of the
        reference's candidates and always returns the true best exact
        score among them; the reference raises its cutoff to each
        accepted candidate's quantized score (``scan.rs:236``), which
        can skip a later candidate whose exact score is higher.

        ``mode="reference"`` replays the reference's rising-cutoff
        algorithm exactly (AVX2 geometry: 32 lanes, 256-row blocks,
        striped candidate order, including its unmasked padding windows
        at indices past ``len - m``), for behavioral parity testing.
        """
        if mode == "reference":
            return _reference_max(
                self.pssm, self.dm, self.seq, self.threshold)
        if mode != "exact":
            raise ValueError(f"unknown max mode {mode!r}")
        # keep every discrete candidate: the f32 keep-filter is -inf
        # while the discrete cutoff still comes from the threshold
        t_scaled = int(self.dm.scale(self.threshold))
        best = None
        for positions, scores in self._scan_segments(t_scaled, -np.inf):
            i = int(np.lexsort((positions, scores))[-1])
            cand = Hit(int(positions[i]), float(scores[i]))
            if best is None or cand > best:
                best = cand
        return best
