"""Motif file-format IO (JASPAR, JASPAR16, TRANSFAC, MEME, UniPROBE).

Counterpart of :mod:`lightmotif_tpu.io`, host Python only.
``load(file, format=..., protein=False)`` mirrors the reference Python
bindings' loader (``lightmotif-py/lightmotif/io.rs:206-315``): it
accepts a path or a text/binary file-like object and yields
:class:`Motif` objects with ``counts`` / ``pwm`` / ``pssm`` populated as
far as the format allows.
"""

from __future__ import annotations

import gzip
import io as _stdio
import os

from ..alphabet import DNA, PROTEIN
from .parsers import (
    read_jaspar,
    read_jaspar16,
    read_meme,
    read_transfac,
    read_uniprobe,
)
from .records import (
    CountRecord,
    FrequencyRecord,
    MemeRecord,
    ParseError,
    TransfacRecord,
)

__all__ = [
    "read_jaspar",
    "read_jaspar16",
    "read_transfac",
    "read_meme",
    "read_uniprobe",
    "load",
    "loads",
    "ParseError",
    "CountRecord",
    "FrequencyRecord",
    "MemeRecord",
    "TransfacRecord",
]

FORMATS = ("jaspar", "jaspar16", "transfac", "meme", "uniprobe")


def _open_text(file):
    """Path / bytes-handle / text-handle -> text handle (gzip-aware)."""
    if isinstance(file, (str, os.PathLike)):
        raw = open(file, "rb")
    elif isinstance(file, bytes):
        # the reference treats bytes as an fsencoded path (io.rs:206-244);
        # raw motif text (which always contains newlines) is accepted as
        # in-memory content for convenience
        if b"\n" in file or b"\r" in file:
            raw = _stdio.BytesIO(file)
        else:
            raw = open(file, "rb")  # raises FileNotFoundError like the ref
    elif hasattr(file, "read"):
        probe = file.read(0)
        if isinstance(probe, str):
            return file
        raw = file
    else:
        raise TypeError(f"cannot read from {type(file).__name__}")
    head = raw.read(2)
    if hasattr(raw, "seek"):
        raw.seek(-len(head), 1)
        if head == b"\x1f\x8b":
            raw = gzip.open(raw, "rb")
    return _stdio.TextIOWrapper(raw)


def _records(handle, format: str, alphabet):
    if format == "jaspar":
        if alphabet is not DNA:
            raise ValueError("raw JASPAR only supports the DNA alphabet")
        return read_jaspar(handle)
    if format == "jaspar16":
        return read_jaspar16(handle, alphabet)
    if format == "transfac":
        return read_transfac(handle, alphabet)
    if format == "meme":
        return iter(read_meme(handle, alphabet))
    if format == "uniprobe":
        return read_uniprobe(handle, alphabet)
    raise ValueError(f"unknown format {format!r}; expected one of {FORMATS}")


def load(file=None, format: str = "jaspar16", protein: bool = False, *,
         data=None):
    """Yield :class:`lightmotif_tpu_torch.Motif` objects from a motif file.

    Each format produces its metadata-carrying subclass
    (:class:`JasparMotif` / :class:`TransfacMotif` / :class:`MemeMotif`
    / :class:`UniprobeMotif`).  Parity note: like the reference's
    ``load()``, matrices are converted with a **zero** pseudocount and
    the file's background if present (``io.rs:41-204``).

    ``data`` passes in-memory motif text (str or bytes) explicitly,
    bypassing the bytes-path-vs-content sniffing of ``file``.
    """
    from ..motif import JasparMotif, MemeMotif, TransfacMotif, UniprobeMotif

    if data is not None:
        if file is not None:
            raise TypeError("pass either file or data, not both")
        file = _stdio.StringIO(data) if isinstance(data, str) \
            else _stdio.BytesIO(data)
    elif file is None:
        raise TypeError("load() needs a file or data")
    alphabet = PROTEIN if protein else DNA
    handle = _open_text(file)
    for record in _records(handle, format, alphabet):
        name = getattr(record, "id", None) or None
        if isinstance(record, CountRecord):
            motif = JasparMotif(
                name=name, description=getattr(record, "description", None)
            )
            motif.counts = record.matrix()
            freq = motif.counts.to_freq(0.0)
        elif isinstance(record, TransfacRecord):
            motif = TransfacMotif(
                name=record.accession or record.id or record.name,
                id=record.id,
                accession=record.accession,
                description=record.description,
                dates=record.dates,
                references=record.references,
                sites=record.sites,
            )
            motif.counts = record.to_counts()
            freq = record.to_freq(0.0)
        elif isinstance(record, MemeRecord):
            motif = MemeMotif(
                name=name,
                evalue=record.evalue,
                nsites=record.nsites,
                url=record.url,
                background=record.background,
            )
            freq = record.matrix()
            motif.pwm = freq.to_weight(record.background)
            motif.pssm = motif.pwm.to_scoring()
            yield motif
            continue
        elif isinstance(record, FrequencyRecord):
            motif = UniprobeMotif(name=name)
            freq = record.matrix()
        else:  # pragma: no cover
            raise TypeError(type(record).__name__)
        if freq is not None:
            motif.pwm = freq.to_weight(None)
            motif.pssm = motif.pwm.to_scoring()
        yield motif


def loads(text, format: str = "jaspar16", protein: bool = False):
    """Like :func:`load` but from in-memory text (str or bytes)."""
    if isinstance(text, (str, bytes)):
        return load(data=text, format=format, protein=protein)
    return load(text, format=format, protein=protein)
