"""Record types shared by the motif-format parsers.

Modeled on the reference's per-format records
(``lightmotif-io/src/*/mod.rs``): each parser yields records exposing
the raw matrix plus format-specific metadata, with ``to_counts`` /
``to_freq`` conversions where the format stores counts.
"""

from __future__ import annotations

import numpy as np

from ..alphabet import Alphabet, Background, as_pseudocounts
from ..matrix import CountMatrix, FrequencyMatrix

__all__ = [
    "CountRecord",
    "FrequencyRecord",
    "TransfacRecord",
    "MemeRecord",
    "ParseError",
]


class ParseError(ValueError):
    """Raised when a motif file cannot be parsed."""


def _counts_from_columns(alphabet: Alphabet, columns: dict) -> CountMatrix:
    """Build a count matrix from per-symbol count rows."""
    lengths = {len(v) for v in columns.values()}
    if len(lengths) != 1:
        raise ParseError("inconsistent matrix row lengths")
    n = lengths.pop()
    data = np.zeros((n, alphabet.size), dtype=np.uint32)
    for sym, values in columns.items():
        idx = alphabet.symbols.index(sym)
        data[:, idx] = values
    return CountMatrix(alphabet, data)


def _freqs_from_columns(alphabet: Alphabet, columns: dict) -> FrequencyMatrix:
    lengths = {len(v) for v in columns.values()}
    if len(lengths) != 1:
        raise ParseError("inconsistent matrix row lengths")
    n = lengths.pop()
    data = np.zeros((n, alphabet.size), dtype=np.float32)
    for sym, values in columns.items():
        idx = alphabet.symbols.index(sym)
        data[:, idx] = values
    return FrequencyMatrix(alphabet, data, _validate=False)


class CountRecord:
    """A record holding a count matrix (JASPAR formats)."""

    __slots__ = ("id", "description", "_matrix")

    def __init__(self, id, matrix: CountMatrix, description=None):
        self.id = id
        self.description = description
        self._matrix = matrix

    def matrix(self) -> CountMatrix:
        return self._matrix

    def to_counts(self) -> CountMatrix:
        return self._matrix

    def to_freq(self, pseudo=0.0) -> FrequencyMatrix:
        return self._matrix.to_freq(pseudo)

    def __repr__(self):  # pragma: no cover
        return f"{type(self).__name__}(id={self.id!r}, len={len(self._matrix)})"


class FrequencyRecord:
    """A record holding a frequency matrix (UniPROBE)."""

    __slots__ = ("id", "_matrix")

    def __init__(self, id, matrix: FrequencyMatrix):
        self.id = id
        self._matrix = matrix

    def matrix(self) -> FrequencyMatrix:
        return self._matrix

    def __repr__(self):  # pragma: no cover
        return f"{type(self).__name__}(id={self.id!r}, len={len(self._matrix)})"


class TransfacRecord:
    """A TRANSFAC record (``transfac/mod.rs:50-130``)."""

    __slots__ = (
        "id",
        "accession",
        "name",
        "description",
        "dates",
        "references",
        "sites",
        "data",
        "alphabet",
    )

    def __init__(
        self,
        alphabet: Alphabet,
        data,
        id=None,
        accession=None,
        name=None,
        description=None,
        dates=(),
        references=(),
        sites=(),
    ):
        self.alphabet = alphabet
        self.data = None if data is None else np.asarray(data, dtype=np.float32)
        self.id = id
        self.accession = accession
        self.name = name
        self.description = description
        self.dates = list(dates)
        self.references = list(references)
        self.sites = list(sites)

    def matrix(self):
        return self.data

    def to_counts(self) -> CountMatrix | None:
        """Counts if the stored matrix is integral, else None
        (``transfac/mod.rs:95-113``)."""
        if self.data is None:
            return None
        rounded = np.round(self.data)
        if not np.array_equal(rounded, self.data):
            return None
        return CountMatrix(self.alphabet, rounded.astype(np.uint32))

    def to_freq(self, pseudo=0.0) -> FrequencyMatrix | None:
        """Normalize the raw matrix rows with pseudocounts."""
        if self.data is None:
            return None
        p = as_pseudocounts(pseudo, self.alphabet)
        probs = self.data + p.counts
        sums = probs.sum(axis=1, keepdims=True, dtype=np.float32)
        return FrequencyMatrix(self.alphabet, probs / sums, _validate=False)

    def __repr__(self):  # pragma: no cover
        return (
            f"TransfacRecord(id={self.id!r}, accession={self.accession!r}, "
            f"len={0 if self.data is None else len(self.data)})"
        )


class MemeRecord:
    """A MEME-format motif (``meme/mod.rs:19-62``)."""

    __slots__ = (
        "id",
        "name",
        "_matrix",
        "alength",
        "w",
        "nsites",
        "evalue",
        "url",
        "background",
    )

    def __init__(
        self,
        id,
        matrix: FrequencyMatrix,
        name=None,
        alength=None,
        w=None,
        nsites=None,
        evalue=None,
        url=None,
        background: Background | None = None,
    ):
        self.id = id
        self.name = name
        self._matrix = matrix
        self.alength = alength
        self.w = w
        self.nsites = nsites
        self.evalue = evalue
        self.url = url
        self.background = background

    def matrix(self) -> FrequencyMatrix:
        return self._matrix

    def __repr__(self):  # pragma: no cover
        return f"MemeRecord(id={self.id!r}, len={len(self._matrix)})"
