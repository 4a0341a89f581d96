"""Score containers.

``StripedScores`` mirrors the reference wrapper
(``lightmotif/src/scores.rs``) for API parity: it exposes ``max`` /
``argmax`` / ``threshold`` / ``unstripe`` and a 2-D matrix view.  The
scoring kernels write flat scores (one per window start), so this
wrapper stores the flat host array plus the striping geometry needed to
reproduce the reference's coordinate conventions.

Tie-breaking: ``argmax`` returns the *last* position attaining the
maximum, matching the reference's ``>=`` update rule
(``pli/mod.rs:144-151``) and ``Scanner::max`` (``scan.rs:235``).
"""

from __future__ import annotations

import numpy as np

__all__ = ["MatrixCoordinates", "Scores", "StripedScores"]


class MatrixCoordinates:
    """A (row, col) pair into a striped matrix view (reference
    ``dense.rs:28-39``)."""

    __slots__ = ("row", "col")

    def __init__(self, row: int, col: int):
        self.row = int(row)
        self.col = int(col)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, MatrixCoordinates)
            and other.row == self.row
            and other.col == self.col
        )

    def __iter__(self):
        return iter((self.row, self.col))

    def __repr__(self) -> str:  # pragma: no cover
        return f"MatrixCoordinates(row={self.row}, col={self.col})"


class Scores:
    """A plain vector of scores (reference ``scores.rs:24-96``)."""

    __slots__ = ("data",)

    def __init__(self, data):
        self.data = np.asarray(data)

    def __len__(self) -> int:
        return int(self.data.size)

    def __getitem__(self, index):
        out = self.data[index]
        if np.isscalar(out) or out.ndim == 0:
            return float(out)
        return Scores(out)

    def __iter__(self):
        return iter(self.data.tolist())

    def __array__(self, dtype=None, copy=None):
        if dtype is None:
            return self.data
        return self.data.astype(dtype)

    def __buffer__(self, flags):
        """Buffer protocol: 1-D read-only score vector."""
        view = self.data.view()
        view.setflags(write=False)
        return memoryview(view)

    def max(self):
        return float(self.data.max()) if self.data.size else None

    def argmax(self):
        if not self.data.size:
            return None
        m = self.data.max()
        return int(np.nonzero(self.data == m)[0][-1])

    def threshold(self, threshold) -> list:
        return np.nonzero(self.data >= threshold)[0].tolist()


class StripedScores:
    """Scores of every sequence position, with a striped 2-D view."""

    __slots__ = ("_flat", "length", "columns")

    def __init__(self, flat, length: int | None = None, columns: int = 32):
        self._flat = np.asarray(flat)
        self.length = int(length) if length is not None else int(self._flat.size)
        self.columns = columns

    # -- accessors ----------------------------------------------------------

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int):
        return float(self._flat[index])

    def __iter__(self):
        return iter(self._flat[: self.length].tolist())

    def __array__(self, dtype=None, copy=None):
        return np.asarray(self._flat[: self.length], dtype=dtype)

    def __buffer__(self, flags):
        """Buffer protocol: the reference's transposed striped view.

        Shape ``[columns, rows]`` with Fortran-order strides
        (``lightmotif-py/lightmotif/lib.rs:1128-1140``): buffer index
        ``[c, r]`` is the score of linear position ``c * rows + r``, so
        the row-major flattening of the buffer walks positions in
        order.  Materialized from the flat scores (the striped
        layout is kernel-internal here); read-only.
        """
        view = self.matrix().T
        view.setflags(write=False)
        return memoryview(view)

    def is_empty(self) -> bool:
        return self.length == 0

    def matrix(self) -> np.ndarray:
        """Materialize the reference's column-major striped matrix view."""
        cols = self.columns
        rows = -(-self.length // cols) if self.length else 0
        flat = np.zeros(rows * cols, dtype=self._flat.dtype)
        flat[: self.length] = self._flat[: self.length]
        return flat.reshape(cols, rows).T.copy()

    def unstripe(self) -> Scores:
        return Scores(np.asarray(self._flat[: self.length]))

    def offset(self, coords: MatrixCoordinates) -> int:
        """Linear sequence position of striped-matrix coordinates
        (reference ``scores.rs:153-157``: ``col * rows + row``)."""
        rows = -(-self.length // self.columns) if self.length else 0
        return coords.col * rows + coords.row

    # -- reductions -----------------------------------------------------------

    def max(self):
        if self.length == 0:
            return None
        return float(np.max(self._flat[: self.length]))

    def argmax(self):
        """Index of the maximum score; last position wins ties."""
        if self.length == 0:
            return None
        valid = self._flat[: self.length]
        m = valid.max()
        return int(np.nonzero(valid == m)[0][-1])

    def threshold(self, threshold) -> list:
        """Positions with score >= threshold (ascending order)."""
        return np.nonzero(self._flat[: self.length] >= threshold)[0].tolist()
