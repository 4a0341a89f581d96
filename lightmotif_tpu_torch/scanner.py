"""Two-pass thresholded scanners.

Counterpart of :mod:`lightmotif_tpu.scanner`: ``Scanner`` for one PSSM
and ``MultiScanner`` for a motif database.  Each segment of the
sequence runs :func:`~.ops.torch_ops.scan_segment` in the ``Scanner``:

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
from .ops import kernels, multi, multi_kernel, torch_ops
from .ops.pipeline import DeviceSequence, as_device_seq, resolve_device

__all__ = ["Hit", "Scanner", "MultiHit", "MultiScanner"]

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
    out ordered by (motif, position).  ``capacity`` is kept for API
    parity with the JAX package; compaction here is exact, so it is
    unused.
    """

    #: Motifs per prefilter group (the JAX package's value; hits do not
    #: depend on it).  Databases with more live motifs split into groups.
    GROUP_MOTIFS = 2048

    #: Motifs longer than this take the dense path; ``None`` = all the
    #: prefilter geometry serves (DNA m <= 128, protein m <= 32).
    DENSE_M_LIMIT: int | None = None

    #: Window starts per segment (the K3 output is 4 bytes per window
    #: start); a bacterial genome is one segment.
    SEGMENT = DEFAULT_SEGMENT

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
        self.device = resolve_device(device)
        self._routing = None  # {"short_idx", "dense_idx"}, fixed per scanner
        self._groups = None  # packed motif groups on the device
        self._dense_dev = {}  # padded dense-path PSSMs on the device
        self._dseq = None
        self._bound = None  # the bound host object
        #: timing hook, ``mark(stage, count)``: called as each stage's
        #: device work is queued, with the count it produced (the stages
        #: of :func:`~.ops.multi.scan_multi_core`, then ``"dense"`` with
        #: the dense path's hits and ``"fetch"`` with all hits); ``None``
        #: = off
        self.mark = None
        if seq is not None:
            self.bind(seq)

    def bind(self, seq) -> "MultiScanner":
        """Bind a (new) sequence; the packed motif groups are reused.
        Re-binding the same object is a no-op (do not mutate a bound
        sequence in place)."""
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
            long_sel = self.lengths > self.dense_m_limit(k)
            live_sel = ~multi.unreachable_thresholds(
                self.pssm_stack, self.thresholds)
            short_idx = np.nonzero(~long_sel & live_sel)[0]
            m_short = int(self.lengths[short_idx].max()) if short_idx.size else 0
            if short_idx.size and multi_kernel.supports_fused(
                    m_short, k, int(short_idx.size)):
                dense_idx = np.nonzero(long_sel & live_sel)[0]
            else:
                dense_idx = np.nonzero(live_sel)[0]
                short_idx = np.zeros(0, np.int64)
            # length-sorted, so each group's rows match its longest motif
            short_idx = short_idx[np.argsort(
                self.lengths[short_idx], kind="stable")]
            self._routing = {"short_idx": short_idx, "dense_idx": dense_idx}
        return self._routing

    def _pack(self) -> list:
        """Pack and upload the motif groups, once per scanner."""
        if self._groups is None:
            k = self.pssms[0].alphabet.size
            short_idx = self._route()["short_idx"]
            n_short = int(short_idx.size)
            gsize = min(self.GROUP_MOTIFS, n_short)
            gstarts = list(range(0, n_short, gsize)) if gsize else []
            multi_group = len(gstarts) > 1
            rpb = multi_kernel.MAX_MK // multi_kernel._lanes_for(k)
            groups = []
            for s in gstarts:
                ids = short_idx[s:s + gsize]
                m_bkt = int(self.lengths[short_idx if self.single_bucket
                                         else ids].max())
                g = multi.pack_motif_group(
                    ids, gsize if multi_group else len(ids),
                    multi.group_bucket(m_bkt, rpb, multi_group),
                    self.pssm_stack, self.thresholds, k)
                dev = multi.group_to_device(g, self.device)
                dev["ids"] = ids
                dev["ids_dev"] = torch.as_tensor(ids, device=self.device)
                groups.append(dev)
            self._groups = groups
        return self._groups

    def dispatch(self) -> dict:
        """Scan the bound sequence on the device and return a token for
        :meth:`fetch`.  The token holds the hits on the device, so
        binding another sequence before fetching is allowed."""
        dseq = self._dseq
        if dseq is None:
            raise ValueError("no sequence bound; use scan(seq)/bind(seq)")
        n_valid = np.maximum(dseq.length - self.lengths + 1, 0).astype(np.int64)
        n_total = int(n_valid.max(initial=0))
        parts = []
        if n_total == 0:
            return {"parts": parts}
        seg = int(self.SEGMENT)
        if seg < 1:
            raise ValueError("SEGMENT must be positive")
        k = self.pssms[0].alphabet.size
        for group in self._pack():
            ids = group["ids"]
            m_pad = group["t_eff"].shape[0]
            for off in range(0, n_total, seg):
                n_here = np.zeros(m_pad, np.int64)
                n_here[: len(ids)] = np.clip(n_valid[ids] - off, 0, seg)
                n_max = int(n_here.max())
                if n_max == 0:
                    continue
                # the segment's window starts plus the group's halo
                chunk = dseq.data[off : off + n_max + group["m_max"] - 1]
                pos, lanes, scores = multi.scan_multi_core(
                    chunk, torch.as_tensor(n_here, device=self.device), group, k,
                    self.mark)
                parts.append((pos + off, group["ids_dev"][lanes], scores))
        n_fused = len(parts)
        for i in self._route()["dense_idx"]:
            i = int(i)
            n_i = int(n_valid[i])
            if n_i == 0:
                continue
            pssm_i = self._dense_dev.get(i)
            if pssm_i is None:
                pssm_pad, _ = multi.pack_dense_motif(self.pssms[i].data, k)
                pssm_i = self._dense_dev[i] = torch.as_tensor(
                    pssm_pad, device=self.device)
            scores = kernels.score_f32(dseq.data, pssm_i, n_i)[:n_i]
            th = torch.tensor(self.thresholds[i], device=self.device)
            pos = torch.nonzero(scores >= th).flatten()
            parts.append((pos, torch.full_like(pos, i), scores[pos]))
        if self.mark is not None and self._route()["dense_idx"].size:
            self.mark("dense", sum(int(p.shape[0]) for p, _, _ in parts[n_fused:]))
        return {"parts": parts}

    def fetch(self, token):
        """Hit arrays ``(motif_ids int32, positions int64, scores
        float32)`` of a :meth:`dispatch` token, ordered by (motif,
        position)."""
        parts = token["parts"]
        if not parts:
            return (np.zeros(0, np.int32), np.zeros(0, np.int64),
                    np.zeros(0, np.float32))
        positions = torch.cat([p for p, _, _ in parts])
        motif_ids = torch.cat([m for _, m, _ in parts])
        scores = torch.cat([s for _, _, s in parts])
        # (motif, position) is unique per hit: one sort of the packed key
        order = torch.argsort((motif_ids << 40) | positions)
        out = (motif_ids[order].to(torch.int32).cpu().numpy(),
               positions[order].cpu().numpy(),
               scores[order].cpu().numpy())
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
