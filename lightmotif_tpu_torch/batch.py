"""Batched scanning of many records in one device pass.

Counterpart of :mod:`lightmotif_tpu.batch`.  Scanning thousands of short
FASTA records (promoter sets, ChIP-seq peaks) one device call at a time
would be dominated by per-call latency, so the records are scanned
together:

* :class:`BatchScanner` concatenates the records with ``m - 1``
  wildcard separators, runs one two-pass :class:`~.scanner.Scanner`
  (one launch per segment, one read) over the concatenation and splits
  the hits back per record;
* :class:`BatchReducer` packs the records into uniform slots, scores
  every window with K1 and reduces each slot to its (max, argmax);
* :class:`MultiBatchScanner` runs the database scan
  (:class:`~.scanner.MultiScanner`, K3) over the concatenation, with
  ``prepare`` / ``rebind_prepared`` and ``dispatch`` / ``fetch`` so a
  streaming reader overlaps the next batch's upload with this one's scan.
  Under ``torch.profiler`` the join (span ``records.join``, counts
  ``records`` and ``residues``) and the upload (``upload.pad``,
  ``upload.copy``) join the next scan's spans, and the hits' mapping to
  records (``records.map``, counts ``hits`` and ``dropped``, those past a
  record's end) the scan they come from
  (:func:`~.utils.profiling.before_scan`, :func:`~.utils.profiling.after_scan`).

Windows that cross a record boundary touch at least one separator; they
may be candidates but are dropped exactly by the ``local <= len(record)
- m`` rule, so each record's hits equal a per-record scan's.  Every
class takes a ``device`` (``None`` = :func:`.ops.pipeline.default_device`,
which never falls back to the CPU).
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import kernels
from .ops.pipeline import DeviceSequence, pad_length, resolve_device
from .scanner import Hit, MultiHit, MultiScanner, Scanner
from .sequence import EncodedSequence
from .utils import profiling

__all__ = ["BatchScanner", "BatchReducer", "MultiBatchScanner"]


def _concatenate(seqs, gap: int, alphabet, pad_to: int | None = None):
    """Concatenate records with ``gap`` wildcard separators.

    ``pad_to`` extends the result with trailing wildcards to a fixed
    length (hits cannot originate there: every tail window fails the
    ``local <= len(record) - m`` rule).  Returns ``(concatenation,
    offsets, lengths)``."""
    seqs = list(seqs)
    if not seqs:
        raise ValueError("no sequences given")
    offsets = np.zeros(len(seqs), dtype=np.int64)
    lengths = np.zeros(len(seqs), dtype=np.int64)
    parts = []
    pos = 0
    pad = np.full(gap, alphabet.default_index, dtype=np.uint8)
    for i, s in enumerate(seqs):
        if not isinstance(s, EncodedSequence):
            s = EncodedSequence(s, alphabet)
        offsets[i] = pos
        lengths[i] = len(s)
        parts.append(np.asarray(s.data, dtype=np.uint8))
        parts.append(pad)
        pos += len(s) + gap
    if pad_to is not None and pad_to > pos:
        parts.append(np.full(pad_to - pos, alphabet.default_index, dtype=np.uint8))
    data = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
    return EncodedSequence(data, alphabet), offsets, lengths


def _split(positions, scores, offsets, lengths, m):
    """Map concatenated-space hits back to (record, local) hits."""
    record = np.searchsorted(offsets, positions, side="right") - 1
    local = positions - offsets[record]
    keep = local <= lengths[record] - m
    return record[keep], local[keep], scores[keep]


class BatchScanner:
    """Scan one PSSM over many records in a single device pass."""

    def __init__(self, pssm, seqs, threshold: float = 0.0,
                 pad_to: int | None = None, **kw):
        self.pssm = pssm
        gap = max(len(pssm) - 1, 0)
        self._concat, self._offsets, self._lengths = _concatenate(
            seqs, gap, pssm.alphabet, pad_to)
        self._scanner = Scanner(pssm, self._concat, threshold=threshold, **kw)

    def collect(self) -> list:
        """Per-record hit lists (``[[Hit, ...], ...]``), each ordered by
        position like a per-record :class:`~.scanner.Scanner` run: the
        concatenation's hits come in position order, so each record's do."""
        sc = self._scanner
        pos, scores = sc._hits(int(sc.dm.scale(sc.threshold)), sc.threshold)
        out = [[] for _ in self._offsets]
        rec, local, kept = _split(pos, scores, self._offsets, self._lengths, len(self.pssm))
        for r, p, s in zip(rec.tolist(), local.tolist(), kept.tolist()):
            out[r].append(Hit(p, s))
        return out


class BatchReducer:
    """Per-record ``max``/``argmax`` of one PSSM over many records.

    Records pack into uniform slots of ``max(len) + m - 1``
    wildcard-padded positions, K1 scores the concatenation, and two
    masked row reductions give each record's result; only ``2n`` values
    leave the device.

    Tie rule per record: the last maximal position wins (the
    reference's ``>=`` update), also when every valid window scores
    ``-inf`` (the tie then lands on the last valid start, like the host
    oracle).  Records shorter than the motif yield ``(-inf, -1)``.

    ``slot`` and ``n_slots`` pin the geometry: a batch that needs more
    raises.  An unpinned dimension ratchets (it only grows), as in the
    JAX package, whose compiled program it keeps from retracing.
    """

    def __init__(self, pssm, seqs=None, slot: int | None = None,
                 n_slots: int | None = None, device=None):
        self.pssm = pssm
        self._m = len(pssm)
        self.slot = int(slot) if slot else 0
        self.n = int(n_slots) if n_slots else 0
        self._pin_slot = bool(slot)
        self._pin_n = bool(n_slots)
        self.device = resolve_device(device)
        self._pssm_dev = torch.as_tensor(
            np.ascontiguousarray(pssm.data, np.float32), device=self.device)
        self._flat = self._n_valid = None
        self._n_records = 0
        self._out = None
        if seqs is not None:
            self.rebind(seqs)

    def rebind(self, seqs) -> "BatchReducer":
        """Bind a new batch of records."""
        alphabet = self.pssm.alphabet
        m = self._m
        seqs = [s if isinstance(s, EncodedSequence) else EncodedSequence(s, alphabet)
                for s in seqs]
        if not seqs:
            raise ValueError("no sequences given")
        self._lengths = np.asarray([len(s) for s in seqs], np.int64)
        self._n_records = len(seqs)
        need_slot = int(self._lengths.max()) + max(m - 1, 0)
        if ((self._pin_slot and need_slot > self.slot)
                or (self._pin_n and self._n_records > self.n)):
            raise ValueError(
                f"batch needs slot={need_slot} x n={self._n_records}, "
                f"pinned geometry is slot={self.slot} x n={self.n}")
        # uniform slots: record i starts at i * slot, so the scores
        # reshape to [n, slot]; the m - 1 tail keeps windows from reading
        # the next record
        self.slot = max(self.slot, need_slot)
        self.n = max(self.n, self._n_records)
        flat = np.full(pad_length(self.n * self.slot), alphabet.default_index, np.uint8)
        for i, s in enumerate(seqs):
            flat[i * self.slot : i * self.slot + len(s)] = s.data
        n_valid = np.zeros(self.n, np.int64)
        n_valid[: self._n_records] = np.maximum(self._lengths - m + 1, 0)
        self._flat = torch.from_numpy(flat).to(self.device)
        self._n_valid = torch.from_numpy(n_valid).to(self.device)
        self._out = None
        return self

    def _reduce(self):
        if self._flat is None:
            raise ValueError("no records bound; use rebind(seqs)")
        if self._out is None:
            n, slot = self.n, self.slot
            scores = kernels.score_f32(self._flat, self._pssm_dev, n * slot)
            s = scores[: n * slot].reshape(n, slot)
            pos = torch.arange(slot, device=self.device)
            valid = pos < self._n_valid[:, None]
            s = torch.where(valid, s, float("-inf"))
            mx = s.amax(dim=1)
            # ties restricted to valid starts: when mx is -inf the masked
            # tail compares equal too, and the last-max rule must land on
            # the last valid start, not the slot edge
            am = torch.where((s == mx[:, None]) & valid, pos, -1).amax(dim=1)
            r = self._n_records
            self._out = (mx[:r].cpu().numpy(), am[:r].to(torch.int32).cpu().numpy())
        return self._out

    def max(self) -> np.ndarray:
        """f32 best score per record (``-inf`` when no valid window)."""
        return self._reduce()[0]

    def argmax(self):
        """``(positions int64, scores f32)`` per record; position is
        ``-1`` when the record has no valid window."""
        mx, am = self._reduce()
        return am.astype(np.int64), mx


class MultiBatchScanner:
    """Scan many PSSMs over many records in a single device pass.

    The packed motif database and its device uploads persist across
    :meth:`rebind` calls, so a streaming consumer pays the preparation
    once per database.  Keyword arguments go to
    :class:`~.scanner.MultiScanner` (``device``, ``capacity``, ...).
    """

    def __init__(self, pssms, seqs=None, thresholds=0.0,
                 pad_to: int | None = None, **kw):
        self.pssms = list(pssms)
        if not self.pssms:
            raise ValueError("no motifs given")
        m_max = max(len(p) for p in self.pssms)
        self.gap = max(m_max - 1, 0)
        self._m = np.asarray([len(p) for p in self.pssms])
        self._offsets = self._lengths = None
        self._scanner = MultiScanner(self.pssms, thresholds=thresholds, **kw)
        if seqs is not None:
            self.rebind(seqs, pad_to)

    @property
    def device(self) -> torch.device:
        return self._scanner.device

    def rebind(self, seqs, pad_to: int | None = None) -> "MultiBatchScanner":
        """Bind a new batch of records, reusing the packed motif set."""
        return self.rebind_prepared(self.prepare(seqs, pad_to))

    def prepare(self, seqs, pad_to: int | None = None):
        """Concatenate records and upload the batch to the device
        without binding it, so a reader can prepare batch ``n + 1``
        while batch ``n`` scans."""
        with profiling.before_scan():
            with profiling.span("records.join") as span:
                concat, offsets, lengths = _concatenate(
                    seqs, self.gap, self.pssms[0].alphabet, pad_to)
                if span:
                    span.add(records=len(lengths), residues=int(lengths.sum()))
            return DeviceSequence(concat, self.device), offsets, lengths

    def rebind_prepared(self, prepared) -> "MultiBatchScanner":
        """Bind a batch built by :meth:`prepare`."""
        dseq, self._offsets, self._lengths = prepared
        self._scanner.bind(dseq)
        return self

    def collect_arrays(self):
        """Hits as flat arrays ``(records, motif_ids, positions,
        scores)`` with per-record local positions, ordered by (motif,
        concatenated position)."""
        if self._offsets is None:
            raise ValueError("no records bound; use rebind(seqs)")
        return self._split_hits(self._scanner.collect_arrays(),
                                self._offsets, self._lengths)

    def dispatch(self):
        """Queue the scan of the bound batch; returns a token for
        :meth:`fetch`.  The token holds its own record offsets and device
        hits, so the next batch may be bound and dispatched first."""
        if self._offsets is None:
            raise ValueError("no records bound; use rebind(seqs)")
        return (self._scanner.dispatch(), self._offsets, self._lengths)

    def fetch(self, token):
        """The hits of a :meth:`dispatch` token, in the form of
        :meth:`collect_arrays`."""
        inner, offsets, lengths = token
        return self._split_hits(self._scanner.fetch(inner), offsets, lengths)

    def _split_hits(self, raw, offsets, lengths):
        with profiling.after_scan(), profiling.span("records.map") as span:
            mo, pos, sc = (np.asarray(raw[0], np.int32), np.asarray(raw[1], np.int64),
                           np.asarray(raw[2], np.float32))
            if pos.size == 0:
                out = (np.zeros(0, np.int64), mo, pos, sc)
            else:
                rec = np.searchsorted(offsets, pos, side="right") - 1
                local = pos - offsets[rec]
                keep = local <= lengths[rec] - self._m[mo]
                out = rec[keep], mo[keep], local[keep], sc[keep]
            if span:
                span.add(hits=len(out[0]), dropped=len(pos) - len(out[0]))
            return out

    def collect(self) -> list:
        """Per-record lists of :class:`~.scanner.MultiHit`, ordered by
        (motif, position)."""
        rec, mo, local, sc = self.collect_arrays()
        out = [[] for _ in self._offsets]
        for r, m, p, s in zip(rec.tolist(), mo.tolist(), local.tolist(), sc.tolist()):
            out[r].append(MultiHit(m, p, s))
        for lst in out:
            lst.sort(key=lambda h: (h.motif, h.position))
        return out
