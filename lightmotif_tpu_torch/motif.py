"""Motif container: counts + weights + scoring matrix + name.

``Motif`` mirrors the reference Python bindings' class
(``lightmotif-py/lightmotif/lib.rs:1160-1226``).  The per-format
subclasses of ``lightmotif_tpu.motif`` come with the motif-file slice.
"""

from __future__ import annotations

__all__ = ["Motif"]


class Motif:
    """A named motif: counts + weights + scoring matrix."""

    __slots__ = ("counts", "pwm", "pssm", "name")

    def __init__(self, counts=None, pwm=None, pssm=None, name=None):
        self.counts = counts
        self.pwm = pwm
        self.pssm = pssm
        self.name = name

    def __repr__(self) -> str:  # pragma: no cover
        w = len(self.pssm) if self.pssm is not None else None
        return f"{type(self).__name__}(name={self.name!r}, width={w})"
