"""Discretized score distribution for p-value estimation (MEME method).

Parity with the reference (``lightmotif/src/pwm/dist.rs``): the PSSM is
rescaled position-independently into an integer range of ``CDF_RANGE``
(=1000) per row, a PDF is built by dynamic programming over motif
positions weighted by background frequencies, and the survival function
gives ``pvalue(score)`` / ``score(pvalue)``.

The DP is dense and regular -- a few (rows * 1000)-sized float64 vector
ops per motif row -- so it is implemented with vectorized NumPy on the
host.  It runs once per matrix and is cached by callers.
"""

from __future__ import annotations

import numpy as np

__all__ = ["ScoreDistribution", "CDF_RANGE"]

#: Default CDF approximation range used in MEME (``dist.rs:47``).
CDF_RANGE = 1000


class ScoreDistribution:
    """An approximate distribution of the scores of a scoring matrix."""

    __slots__ = (
        "alphabet",
        "scale_",
        "offset_",
        "range_",
        "data",
        "sf_",
        "min_score_",
        "max_score_",
    )

    def __init__(self, pssm):
        alphabet = pssm.alphabet
        mat = np.asarray(pssm.data, dtype=np.float32)
        k = alphabet.size
        rows = mat.shape[0]

        finite = mat[np.isfinite(mat)]
        if finite.size == 0:
            raise ValueError("scoring matrix has no finite values")
        small = float(finite.min())
        large = float(finite.max())
        if small == large:
            small = large - 1.0

        offset = np.floor(small)
        scale = np.floor(CDF_RANGE / (large - offset))

        # Discretized matrix: round((x - offset) * scale); -inf stays a
        # sentinel (the reference's `as i32` saturates -inf to i32::MIN,
        # and the DP skips i32::MIN cells).
        NEG = np.iinfo(np.int32).min
        with np.errstate(invalid="ignore"):
            scaled = np.round((mat.astype(np.float64) - offset) * scale)
        data = np.where(
            np.isfinite(scaled), scaled, float(NEG)).astype(np.int64)

        # -- PDF by dynamic programming (``dist.rs:163-191``) -------------
        size = rows * CDF_RANGE + 1
        bg = np.asarray(pssm.background.frequencies, dtype=np.float64)
        pdf_new = np.zeros(size, dtype=np.float64)
        pdf_new[0] = 1.0
        for i in range(rows):
            max_reach = i * CDF_RANGE
            pdf_old = pdf_new
            pdf_new = np.zeros(size, dtype=np.float64)
            window = pdf_old[: max_reach + 1]
            for a in range(k):
                s = data[i, a]
                if s != NEG:
                    pdf_new[s : s + max_reach + 1] += window * bg[a]

        # -- survival function (``dist.rs:196-213``) ----------------------
        # The reference's loop is ``sf[i] = min(sf[i] + sf[i+1], 1.0)``
        # from the top down.  Until the clamp first engages no value was
        # clamped, so the running value IS the sequential reverse suffix
        # sum; at the first index where that sum exceeds 1 the clamp
        # yields exactly 1.0, and every index below it then computes
        # ``min(p + 1.0, 1.0) = 1.0``.  Hence the whole pass equals
        # ``min(reverse_cumsum(pdf), 1.0)`` BITWISE (cumsum adds in the
        # same order), which vectorizes a 15k-iteration Python loop.
        pdf = pdf_new
        sf = np.minimum(np.cumsum(pdf[::-1])[::-1], 1.0)
        sf[-1] = pdf[-1]  # the loop never writes (or clamps) the top cell
        # loop-faithful bounds: ``p_i`` scanned indices [0, size-2],
        # ``p_next`` indices [1, size-1]; both default to 0
        nz = np.nonzero(pdf)[0]
        lo = nz[nz <= size - 2]
        hi = nz[nz >= 1]
        min_score = int(lo[0]) if lo.size else 0
        max_score = int(hi[-1]) if hi.size else 0

        self.alphabet = alphabet
        self.scale_ = float(scale)
        self.offset_ = int(offset)
        self.range_ = CDF_RANGE
        self.data = data
        self.sf_ = sf
        self.min_score_ = int(min_score)
        self.max_score_ = int(max_score)

    # -- scaling (``dist.rs:75-87``) -----------------------------------------

    def sf(self) -> np.ndarray:
        return self.sf_

    def scale(self, score: float) -> int:
        w = self.data.shape[0]
        return int(round((float(score) - w * self.offset_) * self.scale_))

    def unscale(self, score: int) -> float:
        w = self.data.shape[0]
        return float(
            np.float32(
                np.float32(score) / np.float32(self.scale_)
                + np.float32(w * self.offset_)
            )
        )

    # -- queries (``dist.rs:89-127``) ---------------------------------------

    def pvalue(self, score: float) -> float:
        scaled = self.scale(score)
        if scaled < self.min_score_:
            return 1.0
        if scaled >= len(self.sf_):
            return 0.0
        return float(self.sf_[scaled])

    def pvalues(self, scores) -> np.ndarray:
        """Vectorized :meth:`pvalue` over an array of scores (used by
        the CLI to annotate whole hit batches without a Python loop).
        Matches the scalar path exactly: ``round`` here and in
        :meth:`scale` both round half to even, and non-finite scores
        raise the same exceptions the scalar ``int(round(x))`` does
        (casting inf/nan through ``astype(int64)`` would otherwise
        silently yield an arbitrary clamped p-value)."""
        scores64 = np.asarray(scores, np.float64)
        if not np.isfinite(scores64).all():
            if np.isnan(scores64).any():
                raise ValueError("cannot compute the p-value of NaN")
            raise OverflowError("cannot compute the p-value of infinity")
        w = self.data.shape[0]
        scaled = np.round(
            (scores64 - w * self.offset_) * self.scale_
        ).astype(np.int64)
        out = np.ones(scaled.shape, np.float64)
        out[scaled >= len(self.sf_)] = 0.0
        in_range = (scaled >= self.min_score_) & (scaled < len(self.sf_))
        out[in_range] = self.sf_[scaled[in_range]]
        return out

    def score(self, pvalue: float) -> float:
        if pvalue >= 1.0:
            return self.unscale(self.min_score_)
        if pvalue <= 0.0:
            return self.unscale(self.max_score_)
        # self.sf_ is non-increasing; find insertion point in the same way
        # as Rust binary_search_by over a descending array.
        # searchsorted on the reversed (ascending) array:
        n = len(self.sf_)
        idx = n - int(np.searchsorted(self.sf_[::-1], pvalue, side="left"))
        return self.unscale(idx)

    def min_pvalue(self) -> float:
        return float(self.sf_[self.max_score_])

    def sample(self, rng) -> float:
        """Draw a random score (``dist.rs:227-234``); ``rng`` is a
        ``numpy.random.Generator``."""
        return self.score(float(rng.uniform(0.0, 1.0)))
