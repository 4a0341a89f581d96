"""Encoded and striped sequence containers.

``EncodedSequence`` is the rank-encoded flat form (reference
``lightmotif/src/seq.rs:88-276``).  ``StripedSequence`` reproduces the
reference's column-major striped layout *as an API surface* (buffer
protocol, ``wrap`` rows, ``configure``), because the Python bindings of
the reference expose it -- the scoring kernels consume the flat
``EncodedSequence`` directly (halo handling lives in the kernels and in
the scanner's segments), so the striped matrix is materialized only
when a user asks for it.
"""

from __future__ import annotations

import numpy as np

from .alphabet import (
    DNA,
    PROTEIN,
    Alphabet,
    InvalidSymbolError,
)

__all__ = ["EncodedSequence", "StripedSequence"]

#: Default stripe width, matching the reference's widest SIMD backend
#: (AVX2 lanes = 32, ``dense.rs:17``).  Only affects the *host-side*
#: striped view; the scoring kernels use their own tiling.
DEFAULT_COLUMNS = 32


def _encode_bytes(data: bytes, alphabet: Alphabet, lossy: bool) -> np.ndarray:
    """ASCII -> rank encode using the alphabet's 256-entry LUT."""
    raw = np.frombuffer(data, dtype=np.uint8)
    encoded = alphabet.lut[raw]
    invalid = encoded == 255
    if invalid.any():
        if not lossy:
            pos = int(np.argmax(invalid))
            raise InvalidSymbolError(chr(raw[pos]))
        encoded = np.where(invalid, np.uint8(alphabet.default_index), encoded)
    return encoded


class EncodedSequence:
    """A biological sequence encoded as symbol ranks (uint8)."""

    __slots__ = ("alphabet", "data")

    def __init__(self, data, alphabet: Alphabet | None = None):
        if isinstance(data, EncodedSequence):
            alphabet = alphabet or data.alphabet
            data = data.data
        if alphabet is None:
            alphabet = DNA
        if isinstance(data, str):
            # reference constructor accepts text directly
            # (lightmotif-py/lightmotif/lib.rs:157-180)
            data = _encode_bytes(data.encode("ascii"), alphabet, lossy=False)
        arr = np.asarray(data, dtype=np.uint8)
        if arr.ndim != 1:
            raise ValueError("encoded sequence must be one-dimensional")
        if arr.size and int(arr.max()) >= alphabet.size:
            raise InvalidSymbolError(int(arr.max()))
        self.alphabet = alphabet
        self.data = arr

    # -- constructors -----------------------------------------------------

    @classmethod
    def encode(cls, sequence, alphabet: Alphabet = DNA) -> "EncodedSequence":
        """Encode text, raising :class:`InvalidSymbolError` on unknown
        characters (``seq.rs:111-114``)."""
        if isinstance(sequence, str):
            sequence = sequence.encode("ascii")
        return cls(_encode_bytes(bytes(sequence), alphabet, lossy=False), alphabet)

    @classmethod
    def encode_lossy(cls, sequence, alphabet: Alphabet = DNA) -> "EncodedSequence":
        """Encode text, mapping unknown characters to the wildcard
        (``seq.rs:122-129``)."""
        if isinstance(sequence, str):
            sequence = sequence.encode("ascii")
        return cls(_encode_bytes(bytes(sequence), alphabet, lossy=True), alphabet)

    @classmethod
    def sample(cls, rng, background, length: int) -> "EncodedSequence":
        """Sample a random sequence from background frequencies
        (``seq.rs:133-143``); ``rng`` is a ``numpy.random.Generator``."""
        freqs = np.asarray(background.frequencies, dtype=np.float64)
        freqs = freqs / freqs.sum()
        data = rng.choice(len(freqs), size=length, p=freqs).astype(np.uint8)
        return cls(data, background.alphabet)

    # -- protocol ---------------------------------------------------------

    def __len__(self) -> int:
        return int(self.data.size)

    def __getitem__(self, index):
        if isinstance(index, slice):
            return EncodedSequence(self.data[index], self.alphabet)
        return int(self.data[index])

    def __iter__(self):
        return iter(self.data.tolist())

    def __eq__(self, other) -> bool:
        if isinstance(other, EncodedSequence):
            return self.alphabet == other.alphabet and np.array_equal(
                self.data, other.data
            )
        return NotImplemented

    def __str__(self) -> str:
        symbols = np.frombuffer(
            self.alphabet.symbols.encode("ascii"), dtype=np.uint8
        )
        return symbols[self.data].tobytes().decode("ascii")

    def __repr__(self) -> str:  # pragma: no cover
        s = str(self)
        if len(s) > 40:
            s = s[:37] + "..."
        return f"EncodedSequence({s!r}, alphabet={self.alphabet.name!r})"

    def __array__(self, dtype=None, copy=None):
        if dtype is None:
            return self.data
        return self.data.astype(dtype)

    def __buffer__(self, flags):
        """Buffer protocol: 1-D read-only ``u8`` ranks, matching the
        reference binding (``lightmotif-py/lightmotif/lib.rs:218-245``)."""
        view = self.data.view()
        view.setflags(write=False)
        return memoryview(view)

    # -- operations ---------------------------------------------------------

    def count_symbol(self, symbol) -> int:
        if isinstance(symbol, str):
            symbol = self.alphabet.symbols.index(symbol)
        return int(np.count_nonzero(self.data == symbol))

    def count_symbols(self) -> np.ndarray:
        return np.bincount(self.data, minlength=self.alphabet.size).astype(np.int64)

    def reverse_complement(self) -> "EncodedSequence":
        perm = self.alphabet.complement_permutation.astype(np.uint8)
        return EncodedSequence(perm[self.data[::-1]], self.alphabet)

    def to_striped(self, columns: int = DEFAULT_COLUMNS) -> "StripedSequence":
        return StripedSequence.from_encoded(self, columns=columns)


class StripedSequence:
    """Column-major striped view of an encoded sequence.

    Element ``i`` of the sequence lives at ``[i % rows, i // rows]``
    (reference ``pli/mod.rs:190-196``).  ``wrap`` rows replicate the
    start of each next column shifted by one so that a scoring window
    never crosses a column boundary (``seq.rs:369-381``).

    This container exists for API parity and host-side introspection;
    the scoring kernels never consume it.
    """

    __slots__ = ("alphabet", "length", "wrap", "data", "_columns")

    def __init__(self, data, length: int, alphabet: Alphabet, wrap: int = 0):
        arr = np.asarray(data, dtype=np.uint8)
        if arr.ndim != 2:
            raise ValueError("striped sequence data must be 2-dimensional")
        if arr.shape[0] * arr.shape[1] < length:
            raise ValueError("matrix too small for declared sequence length")
        self.alphabet = alphabet
        self.length = int(length)
        self.wrap = int(wrap)
        self.data = arr
        self._columns = arr.shape[1]

    # -- constructors -----------------------------------------------------

    @classmethod
    def from_encoded(
        cls, encoded: EncodedSequence, columns: int = DEFAULT_COLUMNS
    ) -> "StripedSequence":
        length = len(encoded)
        rows = -(-length // columns) if length else 0
        data = np.full(
            (rows, columns), encoded.alphabet.default_index, dtype=np.uint8
        )
        if length:
            flat = np.full(
                rows * columns, encoded.alphabet.default_index, dtype=np.uint8
            )
            flat[:length] = encoded.data
            # element i -> [i % rows, i // rows]: column-major fill.
            data = flat.reshape(columns, rows).T.copy()
        return cls(data, length, encoded.alphabet)

    # -- accessors ----------------------------------------------------------

    @property
    def columns(self) -> int:
        return self._columns

    @property
    def rows(self) -> int:
        return self.data.shape[0]

    def matrix(self) -> np.ndarray:
        return self.data

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int) -> int:
        rows = self.data.shape[0] - self.wrap
        return int(self.data[index % rows, index // rows])

    def __array__(self, dtype=None, copy=None):
        if dtype is None:
            return self.data
        return self.data.astype(dtype)

    def __buffer__(self, flags):
        """Buffer protocol: the reference's transposed 2-D ``u8`` view.

        Shape is ``[columns, rows]`` with strides ``[1, columns]``
        (``lightmotif-py/lightmotif/lib.rs:303-318``), so buffer index
        ``[c, r]`` addresses striped element ``data[r, c]`` — i.e. the
        row-major flattening of the buffer walks linear sequence
        positions ``c * rows + r`` in order.  Read-only, as in the
        reference.
        """
        view = self.data.T
        view.setflags(write=False)
        return memoryview(view)

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"StripedSequence(length={self.length}, wrap={self.wrap}, "
            f"shape={self.data.shape})"
        )

    # -- operations ---------------------------------------------------------

    def unstripe(self) -> EncodedSequence:
        rows = self.data.shape[0] - self.wrap
        flat = self.data[:rows].T.reshape(-1)[: self.length]
        return EncodedSequence(flat, self.alphabet)

    def configure(self, pssm) -> None:
        """Ensure enough wrap rows for scoring with ``pssm``
        (``seq.rs:360-366``)."""
        if len(pssm) > 0:
            self.configure_wrap(len(pssm) - 1)

    def configure_wrap(self, m: int) -> None:
        """Add wrap-around rows for a motif of length ``m+1``
        (``seq.rs:369-381``)."""
        if m > self.wrap:
            rows = self.data.shape[0] - self.wrap
            new = np.full(
                (rows + m, self._columns),
                self.alphabet.default_index,
                dtype=np.uint8,
            )
            new[: self.data.shape[0]] = self.data
            for i in range(m):
                new[rows + i, : self._columns - 1] = new[i, 1:]
                new[rows + i, self._columns - 1] = self.alphabet.default_index
            self.data = new
            self.wrap = m

    def count_symbol(self, symbol) -> int:
        return self.unstripe().count_symbol(symbol)

    def count_symbols(self) -> np.ndarray:
        return self.unstripe().count_symbols()
