"""Exact score <-> p-value conversion (TFM-PVALUE algorithm).

Re-implementation of Touzet & Varre's TFM-PVALUE as provided by the
reference sidecar crate (``lightmotif-tfmpvalue/src/lib.rs``): the PSSM
is floor-discretized at a granularity, a sparse dynamic program over
integer scores computes tail weights (Q-values), and the granularity is
refined 0.1 -> /10 until the p-value range collapses.

A copy of :mod:`lightmotif_tpu.tfmpvalue`, kept in this package so that
it imports nothing of the JAX package.  This is an irregular,
hash-map-driven host-side computation -- exactly the kind of thing that
does *not* belong on the GPU -- so it stays in NumPy/Python
dictionaries.  Behavioral quirks of the reference are
preserved deliberately (error term skipping row 0, ``qvalues[0]``
lookup seeding the p-value sum) so results match the published
pytfmpval golden values.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np

__all__ = ["TfmPvalue", "Iteration"]


@dataclass
class Iteration:
    """One granularity-refinement step (``lib.rs:373-387``)."""

    score: float
    range: tuple
    granularity: float
    converged: bool


class TfmPvalue:
    """The TFM-PVALUE algorithm over a scoring matrix."""

    def __init__(self, matrix):
        self.matrix = matrix
        m = np.asarray(matrix.data, dtype=np.float64)
        k = matrix.alphabet.size
        self.M = m.shape[0]
        self.K = k

        # permutation by decreasing score range (Lemma 7, lib.rs:50-60)
        ranges = m[:, : k - 1].max(axis=1) - m[:, : k - 1].min(axis=1)
        self.permutation = sorted(range(self.M), key=lambda i: -ranges[i])

        self.granularity = math.nan
        self.offsets = [0] * self.M
        # plain Python ints: -inf cells saturate to i64::MIN like the
        # reference, and offset arithmetic must not overflow
        self.int_matrix = [[0] * k for _ in range(self.M)]
        self.error_max = 0.0
        self.max_score_rows = [0] * self.M
        self.min_score_rows = [0] * self.M
        self.qvalues = [dict() for _ in range(self.M + 1)]
        self._bg = np.asarray(matrix.background.frequencies, dtype=np.float64)
        self._fmat = m

    # -- discretization (lib.rs:86-127) -------------------------------------

    def _recompute(self, granularity: float) -> None:
        assert granularity < 1.0
        M, K = self.M, self.K
        mat = self._fmat
        self.granularity = granularity

        I64_MIN, I64_MAX = -(2**63), 2**63 - 1
        for i, p in enumerate(self.permutation):
            for j in range(K - 1):
                v = mat[p][j] / granularity
                # Rust `as i64` saturating cast: -inf -> i64::MIN
                if math.isinf(v) or math.isnan(v):
                    self.int_matrix[i][j] = I64_MIN if v < 0 or math.isnan(v) else I64_MAX
                else:
                    self.int_matrix[i][j] = max(I64_MIN, min(I64_MAX, math.floor(v)))
            self.int_matrix[i][K - 1] = 0  # never written by the reference

        # maximum error: reference iterates rows 1..M-1 over *all* K
        # columns (int_matrix wildcard column is 0)
        self.error_max = 0.0
        for i in range(1, M):
            p = self.permutation[i]
            max_e = max(
                mat[p][j] / granularity - float(self.int_matrix[i][j])
                for j in range(K)
            )
            self.error_max += max_e

        for i in range(M):
            row = self.int_matrix[i]
            off = -min(row[: K - 1])
            self.offsets[i] = off
            for j in range(K - 1):
                row[j] += off

        for i in range(M):
            row = self.int_matrix[i][: K - 1]
            self.min_score_rows[i] = min(row)
            self.max_score_rows[i] = max(row)

    # -- sparse DP over Q-values (lib.rs:132-183) ----------------------------

    # Magnitude bound under which the vectorized int64 path is exact.
    # Values beyond this (e.g. -inf cells saturated to i64::MIN and the
    # resulting ~2^63 offsets) keep Python's arbitrary-precision ints.
    _NP_SAFE = 1 << 60

    def _distribution(self, lo: int, hi: int) -> None:
        M, K = self.M, self.K
        sum_max = sum(self.max_score_rows)
        vals = (abs(lo), abs(hi), abs(sum_max)) + tuple(
            abs(v) for row in self.int_matrix for v in row
        )
        if max(vals) < self._NP_SAFE:
            self._distribution_np(lo, hi)
        else:
            self._distribution_dict(lo, hi)

    def _distribution_np(self, lo: int, hi: int) -> None:
        """Vectorized sparse DP: sorted int64 key arrays + np.add.at.

        Mathematically identical to ``_distribution_dict`` (the reference
        loop, lib.rs:132-183); float accumulation order differs only in
        the order duplicate keys merge, which the golden tolerances
        absorb (the reference's own HashMap order is unspecified too).
        """
        for d in self.qvalues:
            d.clear()
        M, K = self.M, self.K
        bg = np.asarray(self._bg[: K - 1], dtype=np.float64)
        im = np.asarray(
            [[self.int_matrix[i][j] for j in range(K - 1)] for i in range(M)],
            dtype=np.int64,
        )

        # maximum score reachable with the suffix from i to M-1
        maxs = np.zeros(M + 1, dtype=np.int64)
        for i in range(M - 1, -1, -1):
            maxs[i] = maxs[i + 1] + self.max_score_rows[i]

        keep0 = im[0] + maxs[1] >= lo
        k0, v0 = im[0][keep0], bg[keep0]
        keys, inv = np.unique(k0, return_inverse=True)
        vals = np.zeros(len(keys), dtype=np.float64)
        np.add.at(vals, inv, v0)
        self.qvalues[0].update(zip((int(k) for k in keys), vals.tolist()))

        sentinel = 0.0
        _CHUNK = 1 << 20  # bound the [N, K-1] expansion's memory
        for pos in range(1, M):
            row = im[pos]
            tail_max = int(maxs[pos + 1])
            kept_keys, kept_vals = [], []
            for s in range(0, len(keys), _CHUNK):
                kc = keys[s : s + _CHUNK]
                vc = vals[s : s + _CHUNK]
                sc = kc[:, None] + row[None, :]
                occ = vc[:, None] * bg[None, :]
                keep = sc + tail_max >= lo
                over = keep & (sc > hi)
                sentinel += float(occ[over].sum())
                ok = keep & ~over
                kept_keys.append(sc[ok])
                kept_vals.append(occ[ok])
            flat_k = np.concatenate(kept_keys) if kept_keys else np.empty(0, np.int64)
            flat_v = np.concatenate(kept_vals) if kept_vals else np.empty(0)
            keys, inv = np.unique(flat_k, return_inverse=True)
            vals = np.zeros(len(keys), dtype=np.float64)
            np.add.at(vals, inv, flat_v)

        last = self.qvalues[M - 1]
        if M > 1:
            last.update(zip((int(k) for k in keys), vals.tolist()))
        # sentinel bucket: seeded with setdefault then accumulated, exactly
        # like the dict path's ``last[hi + 1]`` updates
        last[hi + 1] = last.get(hi + 1, 0.0) + sentinel

    def _distribution_dict(self, lo: int, hi: int) -> None:
        for d in self.qvalues:
            d.clear()
        M, K = self.M, self.K
        bg = self._bg
        im = self.int_matrix

        # maximum score reachable with the suffix from i to M-1
        maxs = [0] * (M + 1)
        for i in range(M - 1, -1, -1):
            maxs[i] = maxs[i + 1] + self.max_score_rows[i]

        q0 = self.qvalues[0]
        for sym in range(K - 1):
            if im[0][sym] + maxs[1] >= lo:
                key = int(im[0][sym])
                q0[key] = q0.get(key, 0.0) + bg[sym]

        self.qvalues[M - 1].setdefault(hi + 1, 0.0)
        for pos in range(1, M):
            row = im[pos]
            prev = self.qvalues[pos - 1]
            cur = self.qvalues[pos]
            last = self.qvalues[M - 1]
            tail_max = maxs[pos + 1]
            for key, val in list(prev.items()):
                for sym in range(K - 1):
                    sc = key + int(row[sym])
                    if sc + tail_max >= lo:
                        occ = val * bg[sym]
                        if sc > hi:
                            # exceeds hi for every suffix: accumulate at
                            # the final position's sentinel bucket
                            last[hi + 1] = last.get(hi + 1, 0.0) + occ
                        else:
                            cur[sc] = cur.get(sc, 0.0) + occ

    # -- lookups (lib.rs:186-287) ---------------------------------------------

    def _lookup_pvalue(self, score: float):
        assert not math.isnan(self.granularity)
        M = self.M
        scaled = score / self.granularity + sum(self.offsets)
        avg = math.floor(scaled)
        hi = math.floor(scaled + self.error_max + 1.0)
        lo = math.floor(scaled - self.error_max - 1.0)

        self._distribution(lo, hi)

        pvalues = {}
        s = hi + 1
        last_keys = sorted(self.qvalues[M - 1].keys())
        total = self.qvalues[0].get(hi + 1, 0.0)
        for key in reversed(last_keys):
            total += self.qvalues[M - 1][key]
            if key >= avg:
                s = key
            pvalues[key] = total

        keys = sorted(pvalues.keys())
        kmax = keys.index(s)
        while kmax > 0 and float(keys[kmax]) >= float(s) - self.error_max:
            kmax -= 1

        pmax = pvalues[keys[kmax]]
        pmin = pvalues[s]
        return (pmin, pmax)

    def _lookup_score(self, pvalue: float, lo: int, hi: int):
        assert not math.isnan(self.granularity)
        M = self.M

        self._distribution(lo, hi)
        pvalues = {}
        keys = sorted(self.qvalues[M - 1].keys())

        total = 0.0
        riter = len(keys) - 1
        while riter > 0:
            total += self.qvalues[M - 1][keys[riter]]
            pvalues[keys[riter]] = total
            if total >= pvalue:
                break
            riter -= 1

        if total > pvalue:
            alpha_e = keys[riter]
            alpha = keys[riter + 1]
        else:
            if riter == 0:
                alpha = keys[0]
                alpha_e = keys[0]
            else:
                alpha = keys[riter]
                alpha_e = keys[riter - 1]
                total += pvalues.get(alpha_e, 0.0)
            pvalues[alpha_e] = total

        if float(alpha - alpha_e) > self.error_max:
            return alpha, (pvalues[alpha], pvalues[alpha])
        return alpha, (pvalues[alpha_e], pvalues[alpha])

    # -- public API (lib.rs:289-364) -------------------------------------------

    def approximate_pvalue(self, score: float, decay: float = 10.0):
        """Iterate with decreasing granularity toward the exact p-value."""
        granularity = 0.1
        converged = False
        while not converged and granularity > 0.0:
            self._recompute(granularity)
            rng = self._lookup_pvalue(score)
            current = granularity
            granularity /= decay
            converged = rng[0] == rng[1]
            yield Iteration(
                score=score, range=rng, granularity=current, converged=converged
            )

    def pvalue(self, score: float) -> float:
        """Exact p-value for a score (iterates until convergence)."""
        it = None
        for it in self.approximate_pvalue(score):
            pass
        assert it is not None and it.converged
        return it.range[0]

    def approximate_score(self, pvalue: float, decay: float = 10.0):
        """Iterate with decreasing granularity toward the exact score."""
        self._recompute(0.1)
        lo = sum(self.min_score_rows)
        hi = sum(self.max_score_rows) + math.ceil(self.error_max + 0.5)
        granularity = 0.1
        converged = False
        while not converged and granularity > 0.0:
            self._recompute(granularity)
            iscore, rng = self._lookup_score(pvalue, lo, hi)
            current = granularity
            granularity /= decay
            e = math.ceil(self.error_max + 0.5)
            lo = math.floor((iscore - e) * decay)
            hi = math.floor((iscore + e) * decay)
            converged = rng[0] == rng[1]
            yield Iteration(
                score=(iscore - sum(self.offsets)) * current,
                range=rng,
                granularity=current,
                converged=converged,
            )

    def score(self, pvalue: float) -> float:
        """Exact score for a p-value (iterates until convergence)."""
        it = None
        for it in self.approximate_score(pvalue):
            pass
        assert it is not None and it.converged
        return it.score
