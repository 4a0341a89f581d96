"""Two-pass thresholded scanners.

Counterpart of :mod:`lightmotif_tpu.scanner`: ``Scanner`` for one PSSM
and ``MultiScanner`` for a motif database.  Each segment of the
sequence runs :func:`~.ops.kernels.scan_segment` in the ``Scanner``, at a
fixed capacity, as the JAX package's ``scan_segment``, in one launch:

1. discrete scores of every window start, an over-estimate of the f32
   score, like the reference's u8 matrix, kept in registers;
2. the candidates at or above the scaled threshold, the first
   ``capacity`` of them in position order with their exact count, their
   exact f32 rescore (sequential-order adds), the final f32 threshold,
   the front compaction of the kept hits and the best of them.

The segments are issued before the host reads anything, as many at a
time as :data:`READ_AHEAD` bytes of hit buffers hold (every segment of a
chromosome at the seed capacity); then one read fetches every issued
segment's counters and the head of its kept hits (:func:`read_heads`).
A segment whose candidates outnumber the capacity runs again at the
next power of two at or above its count, and the scanner keeps that
capacity (the JAX ratchet), so a steady scan reads the device once a
batch: once, unless a dense threshold ratchets the capacity so far that
fewer segments fit the read-ahead.

Segments carry an (m-1)-position halo -- the same overlap rule as the
reference's wrap rows (``seq.rs:369-381``) -- so scratch memory stays
bounded on long sequences.  Hits come out sorted by position.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from .matrix import ScoringMatrix
from .ops import graphs, kernels, multi, multi_kernel
from .ops.pipeline import DeviceSequence, as_device_seq, resolve_device

__all__ = ["Hit", "Scanner", "MultiHit", "MultiScanner"]

#: Window starts per segment of the ``Scanner``, while
#: :data:`READ_AHEAD` bounds the hit buffers that wait for a read.  Each
#: segment is one launch: on an NVIDIA H100 a 248,956,422 bp chromosome
#: scanned in 4 segments of 2**26 in half the time of 15 of 2**24, and in
#: one of 2**28 only a fifth faster with four times the memory
#: (``chip_smoke.py --scale-only``, measured while each segment was read
#: on its own and wrote an int32 score a window start).  A bacterial
#: genome is one segment.
DEFAULT_SEGMENT = 1 << 26

#: Seed capacity of the fixed-size buffers: the ``Scanner``'s candidates
#: per segment, and the database scan's (candidates per segment of a
#: motif group, hits per dense motif), the JAX package's.  Each ratchets.
DEFAULT_CAPACITY = multi.DEFAULT_CAPACITY

#: Bytes of hit buffers (``packed``, 8 bytes a slot of the
#: capacity) that the ``Scanner`` issues before it reads them: 512
#: segments at the seed capacity.  A capacity ratcheted by a dense
#: threshold issues fewer segments a read (one, once a segment's buffer
#: alone outgrows it), so the device memory that waits for a read and the
#: reader's pinned buffer stay bounded whatever the sequence's length.
READ_AHEAD = 1 << 28


@functools.total_ordering
class Hit:
    """A scored position (reference ``scan.rs:53-92``): ordered by
    (score, position)."""

    __slots__ = ("position", "score")

    def __init__(self, position: int, score: float):
        if math.isnan(score):
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


class Segment(NamedTuple):
    """One issued segment (or shard) of a one-PSSM scan: its ``counts``
    (int32 ``[3]``), ``packed`` (int32 ``[2, cap]``) and ``best`` (int32
    ``[2]``) on its device (:func:`~.ops.kernels.scan_segment`), the
    ``offset`` added to its positions, the ``key`` of its head hint, and
    ``run(cap)``, which issues it again at another capacity and returns
    ``(counts, packed, best)``."""

    counts: torch.Tensor
    packed: torch.Tensor
    best: torch.Tensor
    offset: int
    key: object
    run: Callable


def issue_segment(run: Callable, offset: int, key, cap: int) -> Segment:
    """``run(cap)`` issued (no read), as a :class:`Segment`."""
    return Segment(*run(cap), offset, key, run)


def read_pieces(pieces: list, read) -> list:
    """Every entry's 1-D int32 tensors (``pieces[i]``, on one device each)
    in one read: each device's pieces laid end to end on it, copied to
    the device of the first entry with any (copies on the current
    streams) and read there.  Returns each entry's pieces as numpy
    copies, ``[]`` for an entry with none."""
    by_device = {}
    for i, ts in enumerate(pieces):
        if ts:
            by_device.setdefault(ts[0].device, []).append(i)
    out = [[] for _ in pieces]
    if not by_device:
        return out
    first = next(iter(by_device))
    flats = [torch.cat([t for i in idx for t in pieces[i]]) for idx in by_device.values()]
    flat = read(flats[0] if len(flats) == 1
                else torch.cat([f.to(first, non_blocking=True) for f in flats]))
    at = 0
    for idx in by_device.values():
        for i in idx:
            for t in pieces[i]:
                out[i].append(flat[at : at + t.numel()].copy())
                at += t.numel()
    return out


def _rerun(segments: list, counts: np.ndarray, cap: int) -> tuple:
    """Issue again, once each at the ratcheted capacity (no read), the
    segments whose candidates outnumbered ``cap``.  Returns ``(segments,
    cap, rerun indices)``."""
    over = np.nonzero(counts[:, 0] > cap)[0].tolist()
    if not over:
        return segments, cap, over
    cap = multi.ratchet(cap, int(counts[:, 0].max()))
    segments = list(segments)
    for i in over:
        segments[i] = issue_segment(segments[i].run, segments[i].offset, segments[i].key, cap)
    return segments, cap, over


_EMPTY = [np.zeros(0, np.int32)] * 2


def read_heads(segments: list, hints: dict, read) -> tuple:
    """One read (:func:`read_pieces`): every issued segment's counters
    and the head of its kept hits, :func:`~.ops.multi.head_width` of its
    key's hint in ``hints`` at its capacity.  Returns ``(counts int64
    [segments, 3], widths, heads)``, ``heads[i]`` the positions and f32
    bits of the head."""
    widths = [multi.head_width(hints.get(s.key, 0), s.packed.shape[1]) for s in segments]
    got = read_pieces([[s.counts, s.packed[0, :w], s.packed[1, :w]]
                       for s, w in zip(segments, widths)], read)
    return np.stack([g[0] for g in got]).astype(np.int64), widths, [g[1:] for g in got]


def settle(segments: list, kept: list, widths: list, heads: list, hints: dict, read) -> tuple:
    """The kept hits of segments that fit their capacity, from
    :func:`read_heads`' heads and their ``kept`` counts, and one more read
    of the hits past the heads where a segment keeps more.  Each key's
    hint becomes ``max(hint // 2, n_kept)``.  Returns per segment its
    positions (int64, shifted by its offset) and f32 scores, in position
    order."""
    tails = read_pieces([[s.packed[0, w:k], s.packed[1, w:k]] if k > w else []
                         for s, w, k in zip(segments, widths, kept)], read)
    positions, scores = [], []
    for s, head, tail, k in zip(segments, heads, tails, kept):
        tail = tail or _EMPTY
        positions.append(np.concatenate([head[0], tail[0]])[:k].astype(np.int64) + s.offset)
        scores.append(np.concatenate([head[1], tail[1]])[:k].view(np.float32))
        hints[s.key] = max(hints.get(s.key, 0) >> 1, k)
    return positions, scores


def kept_hits(segments: list, cap: int, hints: dict, read) -> tuple:
    """The kept hits of issued segments, one read in steady state
    (:func:`read_heads`); then, only where needed, the re-runs of the
    segments that overflowed ``cap``, all at once (one more read, their
    counters), and the hits past the heads (:func:`settle`, one more).

    Returns ``(positions int64, scores float32, cap, reruns, kept)``:
    the hits ordered as the segments (each segment's in position order,
    shifted by its offset), the capacity the segments needed, the
    indices of the re-run segments and each segment's kept count."""
    n = len(segments)
    counts, widths, heads = read_heads(segments, hints, read)
    segments, cap, over = _rerun(segments, counts, cap)
    if over:
        again = read_pieces([[segments[i].counts] if i in over else [] for i in range(n)], read)
        for i in over:
            counts[i], widths[i], heads[i] = again[i][0], 0, _EMPTY
    positions, scores = settle(segments, counts[:, 1].tolist(), widths, heads, hints, read)
    return (np.concatenate(positions) if n else np.zeros(0, np.int64),
            np.concatenate(scores) if n else np.zeros(0, np.float32), cap, over, counts[:, 1])


def best_of(scores: torch.Tensor, positions: torch.Tensor) -> tuple:
    """``(max score, the largest position holding it)`` of two vectors on
    one device, left there (the reference's last-max rule,
    ``pli/mod.rs:146``)."""
    top = scores.max()
    return top, torch.where(scores == top, positions, -1).max()


def _segment_best(s: Segment) -> tuple:
    """A segment's best kept hit on its device, from the kernel's
    ``best``: ``(score, position)``, ``(-inf, -1)`` when it keeps none."""
    position = s.best[1]
    return (s.best[:1].view(torch.float32)[0],
            torch.where(position < 0, -1, position.to(torch.int64) + s.offset))


def merge_best(pairs: list) -> tuple:
    """``(score, position)`` scalar tensors merged by the last-max rule
    (:func:`best_of`), with no read: those of each device on it, then
    each device's on the device of the first pair, where the merged pair
    is left."""
    by_device = {}
    for pair in pairs:
        by_device.setdefault(pair[0].device, []).append(pair)
    first = pairs[0][0].device
    merged = [best_of(*(torch.stack(column) for column in zip(*group)))
              for group in by_device.values()]
    return best_of(*(torch.stack([t.to(first, non_blocking=True) for t in column])
                     for column in zip(*merged)))


def _best_flat(segments: list) -> torch.Tensor:
    """Every segment's counters, in order, then the f32 bits and the
    position of the best kept hit of all (:func:`merge_best`), as one
    int64 tensor on the first segment's device."""
    first = segments[0].counts.device
    top, position = merge_best([_segment_best(s) for s in segments])
    counts = torch.cat([s.counts.to(first, non_blocking=True) for s in segments])
    return torch.cat([counts.to(torch.int64), top.view(torch.int32).to(torch.int64).reshape(1),
                      position.reshape(1)])


def read_best(segments: list, read) -> tuple:
    """One read of issued segments' counters and of their best kept hit,
    merged on the devices (:func:`_best_flat`).  Returns ``(counts int64
    [segments, 3], (score, position) or None)``.  A segment that
    overflowed its capacity gives the best of its first candidates: a
    candidate all the same."""
    n = len(segments)
    host = read(_best_flat(segments))
    bits, position = (int(v) for v in host[3 * n :])
    best = None if position < 0 else (float(np.int32(bits).view(np.float32)), position)
    return host[: 3 * n].reshape(n, 3), best


def best_hit(segments: list, cap: int, read) -> tuple:
    """The best kept hit of issued segments, read once in steady state
    (:func:`read_best`); the segments that overflowed ``cap`` run again,
    all at once, at the ratcheted capacity, and the merge is read once
    more.  Returns ``((score, position) or None, cap, reruns)``."""
    counts, best = read_best(segments, read)
    segments, cap, over = _rerun(segments, counts, cap)
    if over:
        best = read_best(segments, read)[1]
    return best, cap, over


class Scanner:
    """Iterator over hits of a PSSM in a sequence above a threshold.

    ``capacity`` seeds the candidates a segment holds; it ratchets, as in
    the JAX package, to the capacity the scans needed (:attr:`capacity`).
    The segments are issued with no read of the device, in batches of
    :data:`READ_AHEAD` bytes of hit buffers, and each batch is read at
    once (:meth:`_scan`): :attr:`host_reads` counts the reads (one per
    steady :meth:`collect` whose segments fit one batch),
    :attr:`reruns` the segments that ran again at a larger capacity."""

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
        if self.capacity < 1:
            raise ValueError("capacity must be positive")
        self.device = resolve_device(device)
        self._dseq = as_device_seq(seq, self.device)
        self._tables = None  # the f32 and u8 tables on the device
        self._reader = multi.HostReader()
        self._head_hint = {}  # segment offset -> its last n_kept: the head widths
        #: reads of the device since the scanner was made
        self.host_reads = 0
        #: segments re-run at a larger capacity since the scanner was made
        self.reruns = 0

    def _read(self, tensor: torch.Tensor) -> np.ndarray:
        self.host_reads += 1
        return self._reader.read(tensor)

    def _segment_run(self, chunk, n_here: int, t_scaled: int, threshold: float, cap: int):
        pssm_dev, dm_dev = self._tables
        return kernels.scan_segment(chunk, n_here, dm_dev, pssm_dev, t_scaled, threshold, cap)

    def _runs(self, t_scaled: int, threshold: float) -> list:
        """``(offset, run)`` of every segment, in position order;
        ``run(cap)`` issues the segment (no read) and returns its
        ``(counts, packed, best)``."""
        m = len(self.pssm)
        n_total = max(self._dseq.length - m + 1, 0)
        if n_total == 0:
            return []
        if self.block_size < 1:
            raise ValueError("block_size must be positive")
        if self._tables is None:
            self._tables = tuple(
                torch.as_tensor(np.ascontiguousarray(data, dtype=dtype), device=self.device)
                for data, dtype in ((self.pssm.data, np.float32), (self.dm.data, np.uint8)))
        data = self._dseq.data
        runs = []
        for off in range(0, n_total, self.block_size):
            n_here = min(self.block_size, n_total - off)
            runs.append((off, functools.partial(
                self._segment_run, data[off : off + n_here + m - 1], n_here, t_scaled,
                threshold)))
        return runs

    def _issue(self, runs: list) -> list:
        """:meth:`_runs`' segments issued at :attr:`capacity`, with no
        read of the device: their :class:`Segment` s."""
        return [issue_segment(run, off, off, self.capacity) for off, run in runs]

    def _scan(self, t_scaled: int, threshold: float, read_batch) -> None:
        """Every segment, issued in batches of as many segments as
        :data:`READ_AHEAD` bytes of hit buffers hold at :attr:`capacity`
        (at least one), each batch read by ``read_batch(segments)``, which
        returns their counters.  A segment whose candidates outnumbered
        the capacity goes back to the front of the queue, to run once more
        at the next power of two at or above the batch's largest count,
        which the scanner keeps (the JAX ratchet): so a re-run, too, waits
        for its read in batches of the read-ahead."""
        queue = self._runs(t_scaled, threshold)
        while queue:
            cap = self.capacity
            batch = queue[: max(1, READ_AHEAD // (8 * cap))]
            del queue[: len(batch)]
            counts = read_batch(self._issue(batch))
            over = counts[:, 0] > cap
            if over.any():
                self.capacity = multi.ratchet(cap, int(counts[:, 0].max()))
                self.reruns += int(over.sum())
                queue[:0] = [run for run, o in zip(batch, over) if o]

    def _hits(self, t_scaled: int, threshold: float) -> tuple:
        """``(positions int64, scores float32)`` of the kept hits, in
        position order: :meth:`_scan`, each batch read by
        :func:`read_heads` (and :func:`settle` where a segment keeps more
        than its head)."""
        parts = {}

        def read_batch(segments):
            counts, widths, heads = read_heads(segments, self._head_hint, self._read)
            fit = [i for i, (s, c) in enumerate(zip(segments, counts[:, 0].tolist()))
                   if c <= s.packed.shape[1]]
            got = settle([segments[i] for i in fit], counts[fit, 1].tolist(),
                         [widths[i] for i in fit], [heads[i] for i in fit], self._head_hint,
                         self._read)
            for i, p, sc in zip(fit, *got):
                parts[segments[i].offset] = (p, sc)
            return counts

        self._scan(t_scaled, threshold, read_batch)
        if not parts:
            return np.zeros(0, np.int64), np.zeros(0, np.float32)
        return tuple(np.concatenate([parts[off][j] for off in sorted(parts)]) for j in (0, 1))

    def __iter__(self):
        positions, scores = self._hits(int(self.dm.scale(self.threshold)), self.threshold)
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
        can skip a later candidate whose exact score is higher.  The
        segments are those of :meth:`collect`, with the f32 keep-filter
        at ``-inf``; each batch's best is merged on the device and read
        once (:func:`read_best`).

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
        best = []

        def read_batch(segments):
            counts, got = read_best(segments, self._read)
            best.extend([got] if got is not None else [])
            return counts

        self._scan(int(self.dm.scale(self.threshold)), -np.inf, read_batch)
        # the last-max rule: the largest score, then the largest position
        return Hit(*max(best)[::-1]) if best else None


class MultiHit(Hit):
    """A hit annotated with the motif that produced it."""

    __slots__ = ("motif",)

    def __init__(self, motif: int, position: int, score: float):
        super().__init__(position, score)
        self.motif = int(motif)

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"MultiHit(motif={self.motif}, position={self.position}, "
            f"score={self.score})"
        )


class MultiScanner:
    """Scan many PSSMs over a sequence: a motif database in one pass per
    motif group.

    Routing, as in the JAX package: motifs longer than
    :meth:`dense_m_limit` take the dense path (exact f32 scores of every
    window with K1, then the threshold); motifs whose thresholds no
    window can reach are dropped; the rest are sorted by length and
    scanned in groups of :data:`GROUP_MOTIFS` by
    :func:`~.ops.multi.scan_multi_core` (K3, then the exact stages).  A
    motif set with no prefilter geometry (live motifs of length 1 only,
    or an alphabet of 32 symbols or more) takes the dense path whole,
    where the JAX package runs its windows path: the hits are the same.

    ``thresholds`` may be a scalar or one value per motif.  Hits come
    out ordered by (motif, position).

    The scan runs at fixed capacities, as the JAX package's does:
    :meth:`dispatch` issues every group and segment and every dense motif
    with no read of the device, and :meth:`fetch` reads every entry's
    counters and the head of its hits in one read, re-runs the entries
    whose capacities overflowed at doubled capacities, and reads the hits
    past a head in one more.  ``capacity`` seeds each group's candidate
    capacity (its hit capacity grows with its lanes,
    :func:`~.ops.multi.seed_capacities`) and each dense motif's; the
    capacities each needed are kept across scans and binds, so a steady
    scan reads the device once (:attr:`host_reads` counts the reads).
    The hits do not depend on the capacities.

    On a CUDA device a steady scan replays CUDA graphs
    (:mod:`~.ops.graphs`): the dispatch's steps (every (group, segment)
    step and every dense motif) and the merge and sort of the fetch's
    read are each captured at their second issue for the bound sequence
    and its capacities, then replayed; a re-run, a scan with the timing
    hook :attr:`mark` on, and the CPU run eagerly.  :attr:`replays`
    counts the captures and replays.
    """

    #: Motifs per prefilter group (the JAX package's value; hits do not
    #: depend on it).  Databases with more live motifs split into groups.
    GROUP_MOTIFS = 2048

    #: Motifs longer than this take the dense path; ``None`` = all the
    #: prefilter geometry serves (DNA m <= 128, protein m <= 32).
    DENSE_M_LIMIT: int | None = None

    #: Window starts per segment.  A segment's scratch grows with it (the
    #: prefilter's output, 4 bytes per window start; phase C's pass bits,
    #: 512 bytes per candidate of a 2,048-lane group).  On an NVIDIA H100
    #: the steady wall of a 50 Mbp genome against a 4,692-PSSM database
    #: is flat from 2**22 to 2**25 window starts a segment, and one eager
    #: scan's peak memory is least at 2**23 (``chip_smoke.py
    #: --scale-only``).  At 2**23 a bacterial genome is one segment, and a
    #: segment's candidate capacity (at most every window start) stays
    #: inside the int32 guard of 2,048-lane groups
    #: (:func:`~.ops.multi._check_capacities`).
    SEGMENT = 1 << 23

    def __init__(self, pssms, seq=None, thresholds=0.0,
                 capacity: int = DEFAULT_CAPACITY,
                 single_bucket: bool = False, device=None):
        self.pssms = list(pssms)
        if not self.pssms:
            raise ValueError("no motifs given")
        #: bucket every group to the longest live motif, as the JAX
        #: package's one-program mode does
        self.single_bucket = bool(single_bucket)
        k = self.pssms[0].alphabet.size
        self.pssm_stack, self.lengths = multi.stack_motifs(
            [np.asarray(p.data, np.float32) for p in self.pssms], k)
        if np.isscalar(thresholds):
            thresholds = [float(thresholds)] * len(self.pssms)
        self.thresholds = np.asarray(thresholds, dtype=np.float32)
        self.capacity = int(capacity)
        if self.capacity < 1:
            raise ValueError("capacity must be positive")
        self.device = resolve_device(device)
        self._routing = None  # {"short_idx", "dense_idx"}, fixed per scanner
        self._groups = None  # packed motif groups on the device
        self._dense_dev = {}  # dense motif -> its padded PSSM and threshold on the device
        self._dseq = None
        self._bound = None  # the bound host object
        self._owned = None  # window starts past which no hit is kept
        self._group_state = {}  # capacity key -> (cap, cap_hits): the ratchets
        self._head_hint = {}  # capacity key -> its last n_kept: the head widths
        #: the CUDA graphs of the steady scans, per bound sequence
        self.replays = graphs.Replays(self.device)
        self._reader = multi.HostReader()  # every read of the device
        #: reads of the device by :meth:`fetch` since the scanner was made
        self.host_reads = 0
        #: timing hook, ``mark(stage, count)``: called as each stage's
        #: device work is queued, with its count, an int or a tensor on
        #: the device that the hook must not read (the stages of
        #: :func:`~.ops.multi.scan_multi_core`, then ``"dense"`` with the
        #: dense motifs' hits and ``"fetch"`` with all hits); ``None`` =
        #: off
        self.mark = None
        if seq is not None:
            self.bind(seq)

    def bind(self, seq, owned: int | None = None) -> "MultiScanner":
        """Bind a (new) sequence; the packed motif groups are reused.
        Re-binding the same object uploads nothing (do not mutate a bound
        sequence in place).  ``owned``: keep only hits at window starts
        below it (a shard's share, cut on the device); ``None``: every
        window."""
        self._owned = None if owned is None else int(owned)
        if seq is not None and self._dseq is not None and (
                seq is self._bound or seq is self._dseq):
            return self
        dseq = as_device_seq(seq, self.device)
        want = self.pssms[0].alphabet
        if dseq.alphabet.symbols != want.symbols:
            raise ValueError(
                f"sequence alphabet {dseq.alphabet.symbols!r} does not "
                f"match the motif set's {want.symbols!r}")
        self._dseq = dseq
        self._bound = seq
        return self

    def scan(self, seq) -> list:
        """``bind(seq).collect()``."""
        return self.bind(seq).collect()

    def scan_arrays(self, seq):
        """``bind(seq).collect_arrays()``."""
        return self.bind(seq).collect_arrays()

    @classmethod
    def dense_m_limit(cls, k: int) -> int:
        if cls.DENSE_M_LIMIT is not None:
            return cls.DENSE_M_LIMIT
        return multi_kernel.MAX_BLOCKS * (
            multi_kernel.MAX_MK // multi_kernel._lanes_for(k))

    def _route(self) -> dict:
        if self._routing is None:
            k = self.pssms[0].alphabet.size
            short_idx, dense_idx = multi.route_motifs(
                self.pssm_stack, self.lengths, self.thresholds, k,
                self.dense_m_limit(k))
            self._routing = {"short_idx": short_idx, "dense_idx": dense_idx}
        return self._routing

    def _pack(self) -> list:
        """Pack and upload the motif groups (K3) and the dense motifs'
        padded PSSMs and f32 thresholds, once per scanner, so that a scan
        uploads nothing."""
        if self._groups is None:
            k = self.pssms[0].alphabet.size
            self._groups = multi.database_groups(
                self.pssm_stack, self.lengths, self.thresholds,
                self._route()["short_idx"], k, self.device, self.GROUP_MOTIFS,
                single_bucket=self.single_bucket)
            for i in self._route()["dense_idx"].tolist():
                pssm_pad, _ = multi.pack_dense_motif(self.pssms[i].data, k)
                self._dense_dev[i] = (torch.as_tensor(pssm_pad, device=self.device),
                                      torch.tensor(self.thresholds[i], device=self.device))
        return self._groups

    def _pack_from(self, other: "MultiScanner") -> None:
        """Take the packed groups and dense motifs of ``other``, a scanner
        of the same motifs and thresholds on another device, copied to
        this scanner's device: a database is packed on the host once,
        however many devices scan it."""
        copies = {}

        def here(value):
            if torch.is_tensor(value):
                if id(value) not in copies:  # tensors shared in a group stay shared
                    copies[id(value)] = value.to(self.device)
                return copies[id(value)]
            return tuple(here(v) for v in value) if isinstance(value, tuple) else value

        self._routing = other._route()
        self._groups = [{name: here(v) for name, v in g.items()} for g in other._pack()]
        self._dense_dev = {i: here(t) for i, t in other._dense_dev.items()}

    def _steps(self, dseq, owned: int | None = None) -> list:
        """The steps of a scan of the device sequence ``dseq``, window
        starts cut at ``owned``: ``(order, capacity key, run)`` for every
        motif group's segment (:func:`~.ops.multi.group_steps`), then every
        dense motif, ``run(cap, cap_hits)`` dispatching the step eagerly
        and returning its :class:`~.ops.multi.Entry`.  ``order`` sorts the
        steps of several sequences group by group."""
        n_valid = np.maximum(dseq.length - self.lengths + 1, 0).astype(np.int64)
        if owned is not None:
            n_valid = np.minimum(n_valid, owned)
        if int(n_valid.max(initial=0)) == 0:
            return []
        seg = int(self.SEGMENT)
        if seg < 1:
            raise ValueError("SEGMENT must be positive")
        k = self.pssms[0].alphabet.size
        groups = self._pack()
        steps = [((gi, off), gi, run) for gi, off, run in multi.group_steps(
            dseq.data, dseq.length, self.lengths, groups, k, seg, owned, self.mark)]
        for i in self._route()["dense_idx"].tolist():
            if n_valid[i]:
                steps.append(((len(groups), i), ("dense", i), functools.partial(
                    self._dense_run, dseq.data, i, int(n_valid[i]))))
        return steps

    def _dense_run(self, data, i, n_valid, cap, cap_hits):
        return multi.dense_entry(data, *self._dense_dev[i], n_valid, cap, i)

    def _caps(self, key) -> tuple:
        """The ``(cap, cap_hits)`` a step of the capacity key ``key`` runs
        at: its ratchet, else its seed."""
        if isinstance(key, tuple):
            return self._group_state.get(key, (self.capacity, self.capacity))
        return self._group_state.get(key) or multi.seed_capacities(
            self._groups[key], self.capacity)

    def _issue(self, step) -> multi.Entry:
        """Dispatch one of :meth:`_steps` eagerly at its capacity key's
        capacities, on the current stream."""
        _, key, run = step
        return run(*self._caps(key))

    def _graph_key(self, steps) -> tuple:
        """What the graphs of ``steps`` are kept under: each step's order
        and capacities, and the segment."""
        return tuple((order, self._caps(key)) for order, key, _ in steps), int(self.SEGMENT)

    def graphed(self) -> bool:
        """Whether the steady work replays CUDA graphs: on a CUDA device
        with the timing hook off."""
        return self.mark is None and self.device.type == "cuda"

    def dispatch(self) -> dict:
        """Issue the scan of the bound sequence, every motif group and
        segment and every dense motif, with no read of the device; returns
        a token for :meth:`fetch`.  Binding another sequence before
        fetching is allowed: each sequence has graphs of its own, and a
        replay writes its outputs again with the same values."""
        dseq = self._dseq
        if dseq is None:
            raise ValueError("no sequence bound; use scan(seq)/bind(seq)")
        steps = self._steps(dseq, self._owned)
        if not steps:
            return {"entries": []}

        def run():
            return [self._issue(step) for step in steps]

        graphs = None
        if self.graphed():
            graphs = (dseq, self._owned, self._graph_key(steps))
            entries, replayed = self.replays.issue(*graphs, "steps", run)
        else:
            entries, replayed = run(), False
        if self.mark is not None and self._route()["dense_idx"].size:
            dense = [e.counts[2] for e in entries if isinstance(e.key, tuple)]
            self.mark("dense", torch.stack(dense).sum() if dense else 0)
        return {"entries": entries, "replayed": replayed, "graphs": graphs if replayed else None}

    def _read(self, tensor: torch.Tensor) -> np.ndarray:
        self.host_reads += 1
        return self._reader.read(tensor)

    def _sorted_heads(self, entries: list, graphs=None) -> tuple:
        """``(flat, widths)``: :func:`~.ops.multi.sorted_heads` of
        ``entries`` (on this scanner's device) queued with no read, and the
        head widths.  When the entries are the outputs of the steps' graph
        held under ``graphs`` (``(owner, tag, key)``), the merge and sort
        replay a graph kept with it."""
        widths = multi.head_widths(entries, self._head_hint)
        if graphs is None or not self.replays.holds(*graphs, "steps", entries):
            return multi.sorted_heads(entries, widths, multi.heads_info(entries, widths)), widths
        name = tuple(widths)
        info = self.replays.memo(*graphs, ("info", name),
                                 lambda: multi.heads_info(entries, widths))
        flat, _ = self.replays.issue(*graphs, ("heads", name),
                                     lambda: multi.sorted_heads(entries, widths, info))
        return flat, widths

    def fetch(self, token):
        """Hit arrays ``(motif_ids int32, positions int64, scores
        float32)`` of a :meth:`dispatch` token, ordered by (motif,
        position): one read of every entry's counters and hit head, and
        more only for entries that overflowed or outgrew their heads."""
        entries = token["entries"]
        if not entries:
            return multi.merge_hits([])
        flat, widths = self._sorted_heads(entries, token["graphs"])
        first = (*multi.unpack_heads(self._read(flat), len(entries)), widths)
        out = multi.collect_device(entries, self._read, self._group_state, self._head_hint,
                                   first)
        if self.mark is not None:
            self.mark("fetch", len(out[0]))
        return out

    def collect_arrays(self):
        """Hits as three arrays ``(motif_ids, positions, scores)``,
        ordered by (motif, position)."""
        return self.fetch(self.dispatch())

    def collect(self) -> list:
        motif_ids, positions, scores = self.collect_arrays()
        return [
            MultiHit(int(mo), int(p), float(s))
            for mo, p, s in zip(motif_ids, positions, scores)
        ]
