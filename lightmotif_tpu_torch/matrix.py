"""The PSSM construction chain.

``CountMatrix`` -> ``FrequencyMatrix`` -> ``WeightMatrix`` ->
``ScoringMatrix`` -> ``DiscreteMatrix``, with behavioral parity to the
reference (``lightmotif/src/pwm/mod.rs``):

* all arithmetic in float32, with strictly-sequential f32 sums where the
  reference sums sequentially (row normalization, min/max score);
* zero background frequency => odds-ratio 0 => log-odds ``-inf``;
* ``DiscreteMatrix`` quantizes with ``ceil`` so u8 scores *over-estimate*
  f32 scores (guaranteeing the two-pass scanner never misses a hit), and
  saturates casts like Rust ``as u8`` (NaN -> 0, clamp to [0, 255]).

Matrices are NumPy-backed; the scoring matrix is uploaded to the
device lazily by the compute pipeline (:mod:`lightmotif_tpu_torch.ops`).
"""

from __future__ import annotations

import math

import numpy as np

from .alphabet import (
    Alphabet,
    Background,
    InvalidDataError,
    as_background,
    as_pseudocounts,
)
from .sequence import EncodedSequence

__all__ = [
    "CountMatrix",
    "FrequencyMatrix",
    "WeightMatrix",
    "ScoringMatrix",
    "DiscreteMatrix",
]


def _sum_f32(values) -> np.float32:
    acc = np.float32(0.0)
    for v in values:
        acc = np.float32(acc + np.float32(v))
    return acc


def _reverse_complement_rows(data: np.ndarray, alphabet: Alphabet) -> np.ndarray:
    """Reverse the row order and permute columns by symbol complement
    (``pwm/mod.rs:311-322``)."""
    perm = alphabet.complement_permutation
    return data[::-1][:, perm].copy()


class _MatrixBase:
    """Shared behavior of every matrix stage."""

    __slots__ = ("alphabet", "data")

    def __len__(self) -> int:
        return int(self.data.shape[0])

    def __getitem__(self, index):
        return self.data[index]

    def matrix(self) -> np.ndarray:
        return self.data

    def __array__(self, dtype=None, copy=None):
        if dtype is None:
            return self.data
        return self.data.astype(dtype)

    def __buffer__(self, flags):
        """Buffer protocol: the 2-D ``[rows, K]`` read-only view.

        The reference exposes matrix buffers too
        (``lightmotif-py/lightmotif/lib.rs:668-1020``); note its
        ``ScoringMatrix`` buffer declares the transposed shape
        ``[K, rows]`` while keeping row-major strides (``lib.rs:686``),
        which mismatches its own storage for ``rows != K`` — this
        implementation keeps the natural row-major ``[rows, K]`` shape
        instead.
        """
        view = self.data.view()
        view.setflags(write=False)
        return memoryview(view)

    def __eq__(self, other) -> bool:
        return (
            type(other) is type(self)
            and other.alphabet == self.alphabet
            and other.data.shape == self.data.shape
            and bool(np.array_equal(other.data, self.data, equal_nan=True))
        )

    # -- correlation (``pwm/mod.rs:100-144``) -------------------------------

    def dot(self, other, i: int, j: int) -> float:
        return float(
            np.float32(
                _sum_f32(
                    np.float32(x) * np.float32(y)
                    for x, y in zip(self.data[i], other.data[j])
                )
            )
        )

    def norm(self, i: int) -> float:
        return math.sqrt(self.dot(self, i, i))

    def auto_correlation(self, delay: int) -> float:
        n = len(self)
        if delay >= n:
            return 0.0
        norms = [self.norm(i) for i in range(n)]
        c = 0.0
        for i, j in enumerate(range(delay, n)):
            c += self.dot(self, i, j) / (norms[i] * norms[j])
        return c / (n - delay)

    def cross_correlation(self, other) -> float:
        rows = min(len(self), len(other))
        c = 0.0
        for i in range(rows):
            c += self.dot(other, i, i) / (self.norm(i) * other.norm(i))
        return c / rows


class CountMatrix(_MatrixBase):
    """Symbol occurrence counts at each motif position
    (``pwm/mod.rs:146-333``)."""

    __slots__ = ("n",)

    def __init__(self, alphabet: Alphabet | dict, data=None,
                 n: int | None = None, *, protein: bool = False):
        if isinstance(alphabet, dict):
            # reference Python constructor takes a symbol -> counts dict
            # (lightmotif-py/lightmotif/lib.rs:408-460)
            other = CountMatrix.from_dict(alphabet, protein=protein)
            alphabet, data, n = other.alphabet, other.data, other.n
        arr = np.asarray(data, dtype=np.uint32)
        if arr.ndim != 2 or arr.shape[1] != alphabet.size:
            raise InvalidDataError(
                f"count matrix must have {alphabet.size} columns, got {arr.shape}"
            )
        self.alphabet = alphabet
        self.data = arr
        if n is None:
            n = int(arr.sum(axis=1).max()) if arr.shape[0] else 0
        self.n = n

    @classmethod
    def from_sequences(cls, sequences) -> "CountMatrix":
        """Build from same-length encoded sequences
        (``pwm/mod.rs:209-237``)."""
        alphabet = None
        data = None
        n = 0
        for seq in sequences:
            if not isinstance(seq, EncodedSequence):
                raise TypeError("expected EncodedSequence")
            if alphabet is None:
                alphabet = seq.alphabet
                data = np.zeros((len(seq), alphabet.size), dtype=np.uint32)
            if len(seq) != data.shape[0]:
                raise InvalidDataError("sequences must all have the same length")
            np.add.at(data, (np.arange(len(seq)), seq.data), 1)
            n += 1
        if alphabet is None:
            raise InvalidDataError("no sequences given")
        return cls(alphabet, data, n)

    @classmethod
    def from_dict(cls, values: dict, alphabet: Alphabet | None = None,
                  protein: bool = False) -> "CountMatrix":
        """Build from a symbol -> counts mapping (reference Python
        ``CountMatrix.__init__``, ``lib.rs:408-460``)."""
        from .alphabet import DNA, PROTEIN

        if alphabet is None:
            alphabet = PROTEIN if protein else DNA
        lengths = {len(v) for v in values.values()}
        if len(lengths) != 1:
            raise InvalidDataError("count rows must all have the same length")
        n = lengths.pop()
        data = np.zeros((n, alphabet.size), dtype=np.uint32)
        for sym, col in values.items():
            data[:, alphabet.symbols.index(sym)] = col
        return cls(alphabet, data)

    def normalize(self, pseudocount=None) -> "WeightMatrix":
        """Counts -> odds ratios against the uniform background
        (reference Python ``CountMatrix.normalize``, ``lib.rs:500-526``).

        ``pseudocount`` may be None (no pseudocount), a scalar, or a
        symbol -> value mapping.
        """
        return self.to_freq(0.0 if pseudocount is None else pseudocount).to_weight(
            None
        )

    def sequence_count(self) -> int:
        return self.n

    def to_freq(self, pseudo=0.0) -> "FrequencyMatrix":
        """Normalize rows after adding pseudocounts (``pwm/mod.rs:240-258``)."""
        p = as_pseudocounts(pseudo, self.alphabet)
        rows = []
        for src in self.data:
            dst = src.astype(np.float32) + p.counts
            s = _sum_f32(dst)
            rows.append(dst / s)
        probs = (
            np.stack(rows)
            if rows
            else np.zeros((0, self.alphabet.size), dtype=np.float32)
        )
        return FrequencyMatrix(self.alphabet, probs, _validate=False)

    @staticmethod
    def _row_entropy(row: np.ndarray) -> float:
        total = np.float32(row.astype(np.float32).sum())
        if total == 0.0:
            # all-zero rows occur in real TRANSFAC dumps (PRODORIC
            # MX000002 row 01); the reference's NaN probabilities all
            # fail its `p > 0` test, yielding entropy 0
            return 0.0
        acc = np.float32(0.0)
        for n in row:
            pf = np.float32(np.float32(n) / total)
            if pf > 0.0:
                acc = np.float32(acc + np.float32(pf * np.float32(np.log2(pf))))
        return float(np.float32(-acc))

    def entropy(self) -> list:
        """Shannon entropy of each row (``pwm/mod.rs:265-284``)."""
        return [self._row_entropy(row) for row in self.data]

    def consensus(self) -> str:
        """Highest-count symbol per row; lowercase when row entropy >= 1
        (``pwm/mod.rs:291-308``)."""
        out = []
        for row in self.data:
            entropy = self._row_entropy(row)
            best = int(np.argmax(row))  # first max wins, like max_by_key
            # Rust max_by_key returns the *last* max element.
            maxval = row[best]
            for k in range(len(row) - 1, -1, -1):
                if row[k] == maxval:
                    best = k
                    break
            c = self.alphabet.symbols[best]
            out.append(c.lower() if entropy >= 1.0 else c.upper())
        return "".join(out)

    def reverse_complement(self) -> "CountMatrix":
        return CountMatrix(
            self.alphabet, _reverse_complement_rows(self.data, self.alphabet), self.n
        )


class FrequencyMatrix(_MatrixBase):
    """Symbol frequencies at each motif position (``pwm/mod.rs:335-446``)."""

    __slots__ = ()

    def __init__(self, alphabet: Alphabet, data, *, _validate: bool = True):
        arr = np.asarray(data, dtype=np.float32)
        if arr.ndim != 2 or arr.shape[1] != alphabet.size:
            raise InvalidDataError(
                f"frequency matrix must have {alphabet.size} columns, got {arr.shape}"
            )
        if _validate and arr.shape[0]:
            sums = arr.sum(axis=1, dtype=np.float32)
            if not np.all(np.abs(sums - 1.0) < 0.01):
                raise InvalidDataError("matrix rows must sum to 1 (tolerance 0.01)")
        self.alphabet = alphabet
        self.data = arr

    def to_weight(self, background=None) -> "WeightMatrix":
        """Odds ratios against the background; zero background => 0
        (``pwm/mod.rs:376-392``)."""
        bg = as_background(background, self.alphabet)
        freqs = bg.frequencies
        with np.errstate(divide="ignore", invalid="ignore"):
            weights = np.where(
                freqs == 0.0,
                np.float32(0.0),
                self.data / freqs,
            ).astype(np.float32)
        return WeightMatrix(self.alphabet, weights, bg)

    def to_scoring(self, background=None) -> "ScoringMatrix":
        """Log2 odds ratios; zero background => ``-inf``
        (``pwm/mod.rs:415-430``)."""
        bg = as_background(background, self.alphabet)
        freqs = bg.frequencies
        with np.errstate(divide="ignore", invalid="ignore"):
            scores = np.where(
                freqs == 0.0,
                np.float32(-np.inf),
                np.log2(self.data / freqs, dtype=np.float32),
            ).astype(np.float32)
        return ScoringMatrix(self.alphabet, scores, bg)

    def reverse_complement(self) -> "FrequencyMatrix":
        return FrequencyMatrix(
            self.alphabet,
            _reverse_complement_rows(self.data, self.alphabet),
            _validate=False,
        )


class WeightMatrix(_MatrixBase):
    """Odds ratios plus the background they were computed against
    (``pwm/mod.rs:448-555``)."""

    __slots__ = ("background",)

    def __init__(self, alphabet: Alphabet, data, background: Background):
        arr = np.asarray(data, dtype=np.float32)
        if arr.ndim != 2 or arr.shape[1] != alphabet.size:
            raise InvalidDataError("bad weight matrix shape")
        self.alphabet = alphabet
        self.data = arr
        self.background = background

    def rescale(self, background=None) -> "WeightMatrix":
        """Re-express odds ratios against a different background
        (``pwm/mod.rs:471-492``)."""
        bg = as_background(background, self.alphabet)
        if np.array_equal(bg.frequencies, self.background.frequencies):
            return WeightMatrix(self.alphabet, self.data.copy(), self.background)
        ratio = self.background.frequencies / bg.frequencies
        return WeightMatrix(self.alphabet, (self.data * ratio).astype(np.float32), bg)

    def information_content(self) -> float:
        """Sum of ``x * log2(x / b)`` over non-zero-background cells
        (``pwm/mod.rs:495-505``)."""
        freqs = self.background.frequencies
        acc = np.float32(0.0)
        for row in self.data:
            racc = np.float32(0.0)
            for x, b in zip(row, freqs):
                if b == 0.0:
                    term = np.float32(0.0)
                else:
                    with np.errstate(divide="ignore", invalid="ignore"):
                        term = np.float32(x * np.float32(np.log2(np.float32(x / b))))
                racc = np.float32(racc + term)
            acc = np.float32(acc + racc)
        return float(acc)

    def log_odds(self, background=None, base: float = 2.0) -> "ScoringMatrix":
        """Rescale against ``background`` then take log-odds (reference
        Python ``WeightMatrix.log_odds``, ``lib.rs:608-660``)."""
        return self.rescale(background).to_scoring(base)

    def to_scoring(self, base: float = 2.0) -> "ScoringMatrix":
        """Take log-odds with the given base (``pwm/mod.rs:513-526``)."""
        with np.errstate(divide="ignore", invalid="ignore"):
            if base == 2.0:
                data = np.log2(self.data, dtype=np.float32)
            elif base == 10.0:
                data = np.log10(self.data, dtype=np.float32)
            else:
                data = (
                    np.log(self.data, dtype=np.float32)
                    / np.float32(np.log(np.float32(base)))
                ).astype(np.float32)
        return ScoringMatrix(self.alphabet, data, self.background)

    def reverse_complement(self) -> "WeightMatrix":
        return WeightMatrix(
            self.alphabet,
            _reverse_complement_rows(self.data, self.alphabet),
            self.background,
        )


class ScoringMatrix(_MatrixBase):
    """Log-odds position-specific scoring matrix (``pwm/mod.rs:557-718``)."""

    __slots__ = ("background", "_pipeline_cache")

    def __init__(self, alphabet: Alphabet, data, background: Background | None = None):
        arr = np.asarray(data, dtype=np.float32)
        if arr.ndim != 2 or arr.shape[1] != alphabet.size:
            raise InvalidDataError("bad scoring matrix shape")
        self.alphabet = alphabet
        self.data = arr
        self.background = (
            background if background is not None else Background.uniform(alphabet)
        )
        self._pipeline_cache = {}

    # -- bounds (over K-1 columns: wildcard excluded, ``pwm/mod.rs:592-615``)

    def min_score(self) -> float:
        k = self.alphabet.size
        return float(_sum_f32(self.data[:, : k - 1].min(axis=1)))

    def max_score(self) -> float:
        k = self.alphabet.size
        return float(_sum_f32(self.data[:, : k - 1].max(axis=1)))

    def information_content(self) -> float:
        """``(2^x * b) * x`` summed over finite cells (``pwm/mod.rs:617-634``)."""
        freqs = self.background.frequencies
        acc = np.float32(0.0)
        for row in self.data:
            racc = np.float32(0.0)
            for x, b in zip(row, freqs):
                if b == 0.0 or x == -np.inf:
                    term = np.float32(0.0)
                else:
                    term = np.float32(
                        np.float32(np.float32(np.exp2(x, dtype=np.float32)) * b) * x
                    )
                racc = np.float32(racc + term)
            acc = np.float32(acc + racc)
        return float(acc)

    # -- scoring ------------------------------------------------------------

    def score_position(self, seq, pos: int) -> float:
        """Exact f32 score of one window: sequential sum over motif rows
        (``pwm/mod.rs:651-662``)."""
        data = self.data
        m = data.shape[0]
        if isinstance(seq, EncodedSequence):
            window = seq.data[pos : pos + m]
        else:
            window = np.array([seq[pos + j] for j in range(m)], dtype=np.int64)
        vals = data[np.arange(m), window]
        acc = np.float32(0.0)
        for v in vals:
            acc = np.float32(acc + v)
        return float(acc)

    def score_host(self, seq) -> np.ndarray:
        """f32 scores of every position, computed on the host.

        Vectorized over positions but sequential over motif rows, so each
        score is bit-identical to :meth:`score_position` (the adds happen
        in the same j order per element).  Used as the parity oracle for
        the device kernels.
        """
        data = self.data
        m = data.shape[0]
        if isinstance(seq, EncodedSequence):
            s = seq.data
        else:
            s = np.asarray(seq.unstripe().data)
        n = s.size - m + 1
        if n <= 0:
            return np.zeros(0, np.float32)
        acc = data[0][s[:n]].astype(np.float32)
        for j in range(1, m):
            acc += data[j][s[j : j + n]]
        return acc

    def score(self, seq, method: str = "meme"):
        """Score a sequence, or convert a p-value to a score threshold.

        * sequence argument (``EncodedSequence``/``StripedSequence``/
          text): scores every position on the pipeline's device and
          returns :class:`~lightmotif_tpu_torch.scores.StripedScores`
          (``pwm/mod.rs:640-648``);
        * numeric argument: treated as a p-value and converted to the
          score achieving it, matching the reference Python bindings'
          ``ScoringMatrix.score(pvalue, method)`` (``lib.rs:914-940``).
        """
        if isinstance(seq, (int, float)) and not isinstance(seq, bool):
            return self.score_for_pvalue(float(seq), method=method)
        if isinstance(seq, (str, bytes)):
            from .sequence import EncodedSequence as _ES

            seq = _ES.encode(seq, self.alphabet)
        from .ops.pipeline import score as _score

        return _score(self, seq)

    def calculate(self, seq):
        """Alias of :meth:`score` (reference Python bindings name,
        ``lightmotif-py/lightmotif/lib.rs:700-730``)."""
        return self.score(seq)

    # -- statistics ------------------------------------------------------------

    def pvalue(self, score: float, method: str = "meme") -> float:
        """P-value of a score, via exact TFM-PVALUE or the MEME
        distribution (``lib.rs:868-905``)."""
        if method == "tfmpvalue":
            return self._tfmp().pvalue(float(score))
        if method == "meme":
            return self.score_distribution().pvalue(float(score))
        raise ValueError(f"unknown method {method!r}")

    def score_for_pvalue(self, pvalue: float, method: str = "meme") -> float:
        """Score threshold achieving a p-value."""
        if method == "tfmpvalue":
            return self._tfmp().score(float(pvalue))
        if method == "meme":
            return self.score_distribution().score(float(pvalue))
        raise ValueError(f"unknown method {method!r}")

    def _tfmp(self):
        cached = self._pipeline_cache.get("tfmp")
        if cached is None:
            from .tfmpvalue import TfmPvalue

            cached = self._pipeline_cache["tfmp"] = TfmPvalue(self)
        return cached

    def score_distribution(self):
        cached = self._pipeline_cache.get("dist")
        if cached is None:
            cached = self._pipeline_cache["dist"] = self.to_score_distribution()
        return cached

    # -- conversions ----------------------------------------------------------

    def to_discrete(self) -> "DiscreteMatrix":
        return DiscreteMatrix.from_scoring(self)

    def to_score_distribution(self):
        from .dist import ScoreDistribution

        return ScoreDistribution(self)

    def to_weight(self) -> WeightMatrix:
        """Inverse transform ``2**x`` (``pwm/mod.rs:542-553``)."""
        data = np.exp2(self.data, dtype=np.float32)
        return WeightMatrix(self.alphabet, data, self.background)

    def reverse_complement(self) -> "ScoringMatrix":
        return ScoringMatrix(
            self.alphabet,
            _reverse_complement_rows(self.data, self.alphabet),
            self.background,
        )


def _saturating_u8(values: np.ndarray) -> np.ndarray:
    """Rust ``as u8`` float->int cast semantics: NaN -> 0, saturate to
    [0, 255], truncate toward zero."""
    vals = np.nan_to_num(values, nan=0.0, posinf=255.0, neginf=0.0)
    return np.clip(np.trunc(vals), 0, 255).astype(np.uint8)


class DiscreteMatrix(_MatrixBase):
    """PSSM discretized over u8 with *over-estimating* rounding
    (``pwm/mod.rs:720-805``).

    ``unscale(score_u8) >= score_f32`` for every window, which makes the
    u8 matrix a sound pre-filter for the two-pass scanner.
    """

    __slots__ = ("factor", "offsets", "offset")

    def __init__(self, alphabet, data, factor, offsets, offset):
        self.alphabet = alphabet
        self.data = np.asarray(data, dtype=np.uint8)
        self.factor = float(factor)
        self.offsets = np.asarray(offsets, dtype=np.float32)
        self.offset = float(offset)

    @classmethod
    def from_scoring(cls, pssm: ScoringMatrix) -> "DiscreteMatrix":
        k = pssm.alphabet.size
        max_score = np.float32(pssm.max_score())
        # Per-row offset: min over the K-1 non-wildcard columns, with
        # infinite cells replaced by -max_score (``pwm/mod.rs:667-680``).
        body = np.asarray(pssm.data[:, : k - 1], dtype=np.float32)
        if body.shape[1]:
            offsets = np.where(
                np.isinf(body), np.float32(-max_score), body).min(axis=1)
        else:
            offsets = np.zeros(body.shape[0], np.float32)
        offsets = np.asarray(offsets, dtype=np.float32)
        offset = _sum_f32(offsets)
        factor = np.float32(
            np.float32(max_score - offset) / np.float32(np.uint8(255))
        )
        with np.errstate(invalid="ignore"):
            scaled = np.ceil(
                (pssm.data - offsets[:, None]) / factor, dtype=np.float32
            )
        data = _saturating_u8(scaled)
        return cls(pssm.alphabet, data, factor, offsets, offset)

    def scale(self, score: float) -> int:
        """f32 threshold -> u8 threshold, rounding *down*
        (``pwm/mod.rs:782-784``)."""
        val = np.floor(
            np.float32(np.float32(score) - np.float32(self.offset))
            / np.float32(self.factor)
        )
        return int(_saturating_u8(np.asarray(val)))

    def unscale(self, score: int) -> float:
        """u8 score -> f32 upper bound (``pwm/mod.rs:787-790``)."""
        return float(
            np.float32(
                np.float32(np.float32(score) * np.float32(self.factor))
                + np.float32(self.offset)
            )
        )

    def score_position(self, seq, pos: int) -> int:
        """Stepwise-saturating u8 window score, equal to the reference's
        ``adds_epu8`` accumulation (``avx2.rs:292-347``) and to the
        device kernels' clamped sums (saturating at each step equals one
        final ``min(.., 255)`` because partial sums are monotone
        non-decreasing)."""
        data = self.data
        acc = 0
        for j in range(data.shape[0]):
            acc = min(acc + int(data[j, seq[pos + j]]), 255)
        return acc
