"""Carry matrices across packages as plain arrays.

The JAX package (``lightmotif_tpu``) and this one build matrices the
same way, but their classes differ.  These functions rebuild the port's
:class:`~.matrix.ScoringMatrix` and :class:`~.matrix.DiscreteMatrix`
from numpy arrays -- the alphabet's name, ``data``, the background
frequencies and, for a discrete matrix, ``factor``, ``offsets`` and
``offset`` -- and :func:`arrays` gives those arrays back, so a matrix
crosses either way without either package importing the other.
:func:`motif_set` carries a whole motif database across: its matrices,
its thresholds and, on request, the reverse strands.
"""

from __future__ import annotations

import numpy as np

from .alphabet import DNA, PROTEIN, Alphabet, Background
from .matrix import DiscreteMatrix, ScoringMatrix

__all__ = ["scoring_matrix", "discrete_matrix", "arrays", "motif_set"]

_ALPHABETS = {a.name: a for a in (DNA, PROTEIN)}


def _alphabet(name: str) -> Alphabet:
    try:
        return _ALPHABETS[name]
    except KeyError:
        raise ValueError(f"unknown alphabet {name!r}") from None


def scoring_matrix(alphabet_name: str, data, background) -> ScoringMatrix:
    """A scoring matrix from its f32 ``[m, K]`` log-odds and its
    background frequencies (taken as they are, unvalidated)."""
    alpha = _alphabet(alphabet_name)
    bg = Background(alpha, np.asarray(background, np.float32), _validate=False)
    return ScoringMatrix(alpha, np.array(data, dtype=np.float32), bg)


def discrete_matrix(alphabet_name: str, data, factor, offsets,
                    offset) -> DiscreteMatrix:
    """A discrete matrix from its u8 ``[m, K]`` data and its scale."""
    return DiscreteMatrix(_alphabet(alphabet_name),
                          np.array(data, dtype=np.uint8), factor,
                          np.array(offsets, dtype=np.float32), offset)


def arrays(matrix) -> dict:
    """The arrays :func:`scoring_matrix` or :func:`discrete_matrix`
    takes, read from a matrix of either package."""
    out = {"alphabet_name": matrix.alphabet.name,
           "data": np.array(matrix.data)}
    if hasattr(matrix, "factor"):
        out.update(factor=matrix.factor, offsets=np.array(matrix.offsets),
                   offset=matrix.offset)
    else:
        out["background"] = np.array(matrix.background.frequencies)
    return out


def motif_set(matrices, thresholds=None, both_strands: bool = False):
    """A motif database of either package as the port's scoring
    matrices and float32 thresholds, one per matrix (a scalar is
    repeated; ``None`` stays ``None``).

    With ``both_strands`` the reverse complements follow the forward
    matrices, each built by ``reverse_complement()``, and the thresholds
    repeat: the order of the JAX package's whole-database scan
    (``bench.py``)."""
    pssms = [scoring_matrix(**arrays(m)) for m in matrices]
    if thresholds is not None:
        thresholds = np.broadcast_to(
            np.asarray(thresholds, np.float32), (len(pssms),)).copy()
        if both_strands:
            thresholds = np.concatenate([thresholds, thresholds])
    if both_strands:
        pssms += [p.reverse_complement() for p in pssms]
    return pssms, thresholds
