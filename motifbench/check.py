"""The comparison that decides ``correct``: a scan's outputs against the
plain reference (:mod:`.reference`).

Numbers compared, each against the limit of the cell's ``limits`` file:

* ``matrix_gap``: the widest gap between a scoring matrix's cell and the
  reference's (both strands; ``inf`` where only one side is infinite);
* ``threshold_gap``: the widest gap between a threshold and the
  reference's;
* ``score_gap``: the widest gap between a reported hit's score and the
  reference's float64 sum of that window;
* ``missed_hits``: windows that the reference scores at or above the
  threshold by more than the score limit and that the scan does not
  report;
* ``extra_hits``: reported hits below the threshold by more than the
  score limit in the reference, outside the motif's windows, or reported
  twice; in a record set, also a hit whose window is not inside the
  record it names (:func:`place_hits`);
* ``count_drift``: scans of the window whose hit count differs from the
  first scan of the same sequence.

Within the score limit of a threshold (the reference's or the scan's,
whichever is lower, up to whichever is higher) a window may fall either
way: the two sums round differently.
"""

from __future__ import annotations

import numpy as np
import torch

from . import reference

NAMES = ("matrix_gap", "threshold_gap", "score_gap", "missed_hits", "extra_hits",
         "count_drift")


def matrix_gap(got: list, want: list) -> float:
    if len(got) != len(want):
        return float("inf")
    worst = 0.0
    for a, b in zip(got, want):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        if a.shape != b.shape:
            return float("inf")
        same = a == b  # equal infinities included
        with np.errstate(invalid="ignore"):
            diff = np.abs(np.where(same, 0.0, a - b))
        if not np.isfinite(diff).all():
            return float("inf")
        worst = max(worst, float(diff.max(initial=0.0)))
    return worst


def threshold_gap(got: np.ndarray, want: np.ndarray) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    if got.shape != want.shape:
        return float("inf")
    return float(np.abs(got - want).max())


def place_hits(hits: tuple, offsets: np.ndarray, lengths: np.ndarray,
               motif_lengths: np.ndarray) -> tuple:
    """A record set's hits ``(records, motif ids, local positions,
    scores)`` at the reference's own joined positions (``offsets`` and
    ``lengths`` of :func:`.reference.join_records`): ``(motif ids,
    positions, scores, misplaced)``, where ``misplaced`` counts the hits
    that name no record or motif, or whose window is not inside the
    record's."""
    rec, ids, local, sc = (np.asarray(hits[0], np.int64), np.asarray(hits[1], np.int64),
                           np.asarray(hits[2], np.int64), np.asarray(hits[3], np.float32))
    ok = (rec >= 0) & (rec < len(lengths)) & (ids >= 0) & (ids < len(motif_lengths))
    ok &= local >= 0
    ok[ok] &= local[ok] <= lengths[rec[ok]] - motif_lengths[ids[ok]]
    return ids[ok], offsets[rec[ok]] + local[ok], sc[ok], int((~ok).sum())


def judge_hits(windows: reference.Windows, codes: torch.Tensor, hits: tuple,
               t_ref: np.ndarray, t_got: np.ndarray, margin: float) -> dict:
    """``score_gap``, ``missed_hits``, ``extra_hits`` and the hit count of
    one scan's ``hits`` (motif ids, positions, scores) of the sequence
    ``codes`` (uint8 ranks on the reference's device)."""
    dev = windows.device
    n = codes.shape[0]
    n_motifs = len(t_ref)
    ids = torch.from_numpy(np.asarray(hits[0], np.int64)).to(dev)
    pos = torch.from_numpy(np.asarray(hits[1], np.int64)).to(dev)
    got = torch.from_numpy(np.asarray(hits[2], np.float32)).to(dev).double()
    lengths = torch.from_numpy(windows.lengths).to(dev)
    inside = (ids >= 0) & (ids < n_motifs)
    inside &= (pos >= 0) & (pos <= n - lengths[ids.clamp(0, n_motifs - 1)])
    extra = int((~inside).sum())
    ids, pos, got = ids[inside], pos[inside], got[inside]
    keys, _ = torch.sort(ids * (n + 1) + pos)
    twice = int((keys[1:] == keys[:-1]).sum()) if keys.numel() > 1 else 0
    extra += twice
    lo = torch.from_numpy(np.minimum(t_ref, t_got).astype(np.float64) - margin).to(dev)
    hi = torch.from_numpy(np.maximum(t_ref, t_got).astype(np.float64) + margin).to(dev)
    column = torch.full((n_motifs,), -1, dtype=torch.int64, device=dev)
    missed, gap = 0, 0.0
    for ids_g, m_pad, _ in windows.groups:
        ids_g = torch.from_numpy(ids_g).to(dev)
        column[ids_g] = torch.arange(ids_g.numel(), device=dev)
    by_group = {}
    for ids_np, start, sums in windows.sums(codes):
        ids_g = torch.from_numpy(ids_np).to(dev)
        key = int(ids_np[0])
        if key not in by_group:  # this group's reported hits, by position
            mine = torch.isin(ids, ids_g)
            p, order = torch.sort(pos[mine])
            by_group[key] = (p, column[ids[mine][order]], got[mine][order])
        p, c, s = by_group[key]
        a, b = torch.searchsorted(p, torch.tensor([start, start + sums.shape[0]],
                                                  device=dev)).tolist()
        if b > a:
            want = sums[p[a:b] - start, c[a:b]]
            gap = max(gap, float((want - s[a:b]).abs().max()))
            extra += int((want < lo[ids_g[c[a:b]]]).sum())
        r, cc = torch.nonzero(sums >= hi[ids_g], as_tuple=True)
        if r.numel():
            need = ids_g[cc] * (n + 1) + start + r
            at = torch.searchsorted(keys, need).clamp(max=max(keys.numel() - 1, 0))
            found = keys[at] == need if keys.numel() else torch.zeros_like(need, dtype=torch.bool)
            missed += int((~found).sum())
    return {"score_gap": gap, "missed_hits": missed, "extra_hits": extra,
            "hits": int(len(hits[0]))}


def verdict(numbers: dict, limits: dict) -> bool:
    return all(numbers[name] <= limits[name] for name in NAMES)


def lines(numbers: dict, limits: dict) -> list:
    """``name=value limit=limit``, one a number, in :data:`NAMES` order."""
    return [f"check {name}={numbers[name]!r} limit={limits[name]!r}" for name in NAMES]
