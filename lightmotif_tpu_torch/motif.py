"""Motif containers: counts + weights + scoring matrix (+ metadata).

Counterpart of :mod:`lightmotif_tpu.motif`.  ``Motif`` mirrors the
reference Python bindings' class (``lightmotif-py/lightmotif/lib.rs:
1160-1226``); the per-format subclasses carry the extra metadata their
file format provides (``lightmotif-py/lightmotif/io.rs:41-204``).
"""

from __future__ import annotations

__all__ = [
    "Motif",
    "JasparMotif",
    "TransfacMotif",
    "MemeMotif",
    "UniprobeMotif",
]


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


class JasparMotif(Motif):
    """A motif from a JASPAR / JASPAR16 file (``io.rs:96-118``)."""

    __slots__ = ("description",)

    def __init__(self, description=None, **kw):
        super().__init__(**kw)
        self.description = description


class TransfacMotif(Motif):
    """A motif from a TRANSFAC file, with EMBL metadata
    (``io.rs:120-160``)."""

    __slots__ = ("id", "accession", "description", "dates", "references", "sites")

    def __init__(self, id=None, accession=None, description=None,
                 dates=(), references=(), sites=(), **kw):
        super().__init__(**kw)
        self.id = id
        self.accession = accession
        self.description = description
        self.dates = list(dates)
        self.references = list(references)
        self.sites = list(sites)


class MemeMotif(Motif):
    """A motif from a MEME-suite file (``io.rs:162-186``)."""

    __slots__ = ("evalue", "nsites", "url", "background")

    def __init__(self, evalue=None, nsites=None, url=None, background=None, **kw):
        super().__init__(**kw)
        self.evalue = evalue
        self.nsites = nsites
        self.url = url
        self.background = background


class UniprobeMotif(Motif):
    """A motif from a UniPROBE file (``io.rs:188-204``)."""

    __slots__ = ()
