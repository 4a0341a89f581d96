"""Biological alphabets, background frequencies and pseudocounts.

Behavioral parity with the reference implementation
(``lightmotif/src/abc.rs``): the DNA alphabet is ordered ``ACTGN`` (A=0,
C=1, T=2, G=3, N=4 -- *not* alphabetical ACGT), the protein alphabet is
``ACDEFGHIKLMNPQRSTVWYX`` with the wildcard ``X=20`` last, and wildcard
symbols receive zero background frequency / zero pseudocount by default.

Everything in this module is tiny host-side metadata; arrays are NumPy
``float32`` so that downstream arithmetic matches the reference's ``f32``
semantics bit-for-bit where required.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "Alphabet",
    "DNA",
    "PROTEIN",
    "Background",
    "Pseudocounts",
    "InvalidSymbolError",
    "InvalidDataError",
]


class InvalidSymbolError(ValueError):
    """Raised when a character does not belong to the alphabet."""

    def __init__(self, char):
        self.char = char
        super().__init__(f"invalid symbol: {char!r}")


class InvalidDataError(ValueError):
    """Raised when data passed to a constructor is invalid."""


class Alphabet:
    """A biological alphabet with a trailing wildcard symbol.

    Mirrors the reference ``Alphabet`` trait (``abc.rs:50-65``): ``K``
    symbols where the *last* one is the default/wildcard symbol (N for
    DNA, X for protein).
    """

    __slots__ = (
        "name",
        "symbols",
        "size",
        "default_index",
        "_lut",
        "_complement_perm",
        "protein",
    )

    def __init__(self, name: str, symbols: str, complement: str | None = None):
        self.name = name
        self.symbols = symbols
        self.size = len(symbols)  # K, including the wildcard
        self.default_index = self.size - 1
        self.protein = self.size > 5

        # ASCII -> rank lookup table; 255 marks invalid characters.
        # Lowercase letters map like their uppercase counterparts
        # (the reference encoders accept only uppercase; we keep a strict
        # uppercase table and a lossy path in `sequence.py`).
        lut = np.full(256, 255, dtype=np.uint8)
        for i, c in enumerate(symbols):
            lut[ord(c)] = i
        self._lut = lut

        if complement is not None:
            perm = np.array([symbols.index(c) for c in complement], dtype=np.int64)
            self._complement_perm = perm
        else:
            self._complement_perm = None

    # -- basic protocol -----------------------------------------------------

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"Alphabet({self.name!r}, {self.symbols!r})"

    def __eq__(self, other) -> bool:
        return isinstance(other, Alphabet) and other.symbols == self.symbols

    def __hash__(self) -> int:
        return hash(self.symbols)

    def as_str(self) -> str:
        return self.symbols

    @property
    def default_symbol(self) -> str:
        return self.symbols[self.default_index]

    # -- complement ---------------------------------------------------------

    @property
    def can_complement(self) -> bool:
        return self._complement_perm is not None

    def complement_index(self, index: int) -> int:
        if self._complement_perm is None:
            raise TypeError(f"alphabet {self.name!r} has no complement")
        return int(self._complement_perm[index])

    @property
    def complement_permutation(self) -> np.ndarray:
        """Permutation ``p`` such that ``p[i]`` is the complement of rank i."""
        if self._complement_perm is None:
            raise TypeError(f"alphabet {self.name!r} has no complement")
        return self._complement_perm

    # -- encoding -----------------------------------------------------------

    @property
    def lut(self) -> np.ndarray:
        """The 256-entry ASCII->rank table (255 = invalid)."""
        return self._lut


#: The DNA alphabet in reference order ``ACTGN`` (``abc.rs:106-135``),
#: with complement A<->T, C<->G, N<->N.
DNA = Alphabet("dna", "ACTGN", complement="TGACN")

#: The protein alphabet ``ACDEFGHIKLMNPQRSTVWYX`` (``abc.rs:224-256``).
PROTEIN = Alphabet("protein", "ACDEFGHIKLMNPQRSTVWYX")


def _sum_f32(values) -> np.float32:
    """Strictly-sequential float32 sum (matches Rust ``iter().sum::<f32>()``)."""
    acc = np.float32(0.0)
    for v in values:
        acc = np.float32(acc + np.float32(v))
    return acc


class Background:
    """Background frequencies over an alphabet.

    Parity notes (``abc.rs:331-523``):

    * ``uniform()`` assigns ``1/(K-1)`` to every non-wildcard symbol and
      0 to the wildcard.
    * validation requires every frequency in ``[0, 1]`` and the (f32,
      sequential) sum to be exactly 1.0.
    """

    __slots__ = ("alphabet", "frequencies")

    def __init__(self, alphabet: Alphabet, frequencies, *, _validate: bool = True):
        freqs = np.asarray(frequencies, dtype=np.float32).copy()
        if freqs.shape != (alphabet.size,):
            raise InvalidDataError(
                f"expected {alphabet.size} frequencies, got {freqs.shape}"
            )
        if _validate:
            if np.any(freqs < 0.0) or np.any(freqs > 1.0):
                raise InvalidDataError("frequencies must be between 0 and 1")
            if float(_sum_f32(freqs)) != 1.0:
                raise InvalidDataError("frequencies must sum to 1.0")
        freqs.setflags(write=False)
        self.alphabet = alphabet
        self.frequencies = freqs

    # -- constructors ---------------------------------------------------

    @classmethod
    def uniform(cls, alphabet: Alphabet) -> "Background":
        k = alphabet.size
        freqs = np.full(k, np.float32(1.0) / np.float32(k - 1), dtype=np.float32)
        freqs[alphabet.default_index] = 0.0
        return cls(alphabet, freqs, _validate=False)

    @classmethod
    def from_counts(cls, alphabet: Alphabet, counts) -> "Background":
        counts = np.asarray(counts, dtype=np.int64)
        total = int(counts.sum())
        if total == 0:
            raise InvalidDataError("cannot build background from zero counts")
        freqs = counts.astype(np.float32) / np.float32(total)
        return cls(alphabet, freqs, _validate=False)

    @classmethod
    def from_sequence(cls, sequence, unknown: bool = False) -> "Background":
        """Count symbols of one encoded sequence (wildcard excluded unless
        ``unknown=True``, per ``abc.rs:422-434``)."""
        return cls.from_sequences([sequence], unknown=unknown)

    @classmethod
    def from_sequences(cls, sequences, unknown: bool = False) -> "Background":
        alphabet = None
        counts = None
        for seq in sequences:
            if alphabet is None:
                alphabet = seq.alphabet
                counts = np.zeros(alphabet.size, dtype=np.int64)
            counts += seq.count_symbols()
        if alphabet is None:
            raise InvalidDataError("no sequences given")
        if not unknown:
            counts[alphabet.default_index] = 0
        return cls.from_counts(alphabet, counts)

    # -- protocol ---------------------------------------------------------

    def __len__(self) -> int:
        return self.alphabet.size

    def __getitem__(self, index):
        if isinstance(index, str):
            index = self.alphabet.symbols.index(index)
        return float(self.frequencies[index])

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Background)
            and other.alphabet == self.alphabet
            and np.array_equal(other.frequencies, self.frequencies)
        )

    def __repr__(self) -> str:  # pragma: no cover
        return f"Background({self.alphabet.name!r}, {self.frequencies.tolist()})"


class Pseudocounts:
    """Pseudocounts over an alphabet.

    A scalar pseudocount applies to every non-wildcard symbol; the
    wildcard always gets 0 (``abc.rs:558-574``).
    """

    __slots__ = ("alphabet", "counts")

    def __init__(self, alphabet: Alphabet, counts):
        if np.isscalar(counts):
            arr = np.full(alphabet.size, np.float32(counts), dtype=np.float32)
            arr[alphabet.default_index] = 0.0
        else:
            arr = np.asarray(counts, dtype=np.float32).copy()
            if arr.shape != (alphabet.size,):
                raise InvalidDataError(
                    f"expected {alphabet.size} pseudocounts, got {arr.shape}"
                )
        arr.setflags(write=False)
        self.alphabet = alphabet
        self.counts = arr

    @classmethod
    def zero(cls, alphabet: Alphabet) -> "Pseudocounts":
        return cls(alphabet, 0.0)

    def __repr__(self) -> str:  # pragma: no cover
        return f"Pseudocounts({self.alphabet.name!r}, {self.counts.tolist()})"


def as_pseudocounts(value, alphabet: Alphabet) -> Pseudocounts:
    if isinstance(value, Pseudocounts):
        return value
    if isinstance(value, dict):
        arr = np.zeros(alphabet.size, dtype=np.float32)
        for sym, v in value.items():
            arr[alphabet.symbols.index(sym)] = v
        return Pseudocounts(alphabet, arr)
    return Pseudocounts(alphabet, value)


def as_background(value, alphabet: Alphabet) -> Background:
    if value is None:
        return Background.uniform(alphabet)
    if isinstance(value, Background):
        return value
    if isinstance(value, dict):
        arr = np.zeros(alphabet.size, dtype=np.float32)
        for sym, v in value.items():
            arr[alphabet.symbols.index(sym)] = v
        return Background(alphabet, arr)
    return Background(alphabet, value)
