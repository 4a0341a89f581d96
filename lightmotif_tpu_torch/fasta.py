"""Minimal FASTA reading (plain or gzip), host-side ingestion.

Counterpart of :mod:`lightmotif_tpu.fasta`: the native parser and
encoder (:mod:`.native`) first, :func:`read_fasta` with NumPy encoding
when it is unavailable.
"""

from __future__ import annotations

import gzip
import io
import os

__all__ = ["read_fasta", "read_fasta_encoded", "FastaRecord"]


class FastaRecord:
    __slots__ = ("name", "description", "sequence")

    def __init__(self, name: str, description: str | None, sequence: str):
        self.name = name
        self.description = description
        self.sequence = sequence

    def __len__(self) -> int:
        return len(self.sequence)

    def __repr__(self):  # pragma: no cover
        return f"FastaRecord(name={self.name!r}, len={len(self.sequence)})"


def _open_text(file):
    if isinstance(file, (str, os.PathLike)):
        raw = open(file, "rb")
    elif hasattr(file, "read"):
        probe = file.read(0)
        if isinstance(probe, str):
            return file
        raw = file
    else:
        raise TypeError(f"cannot read FASTA from {type(file).__name__}")
    head = raw.read(2)
    raw.seek(-len(head), 1)
    if head == b"\x1f\x8b":
        raw = gzip.open(raw, "rb")
    return io.TextIOWrapper(raw)


def read_fasta(file):
    """Yield :class:`FastaRecord` from a path or file-like object."""
    handle = _open_text(file)
    name = None
    desc = None
    chunks = []
    for line in handle:
        line = line.rstrip()
        if not line:
            continue
        if line.startswith(">"):
            if name is not None:
                yield FastaRecord(name, desc, "".join(chunks))
            parts = line[1:].split(None, 1)
            name = parts[0] if parts else ""
            desc = parts[1] if len(parts) > 1 else None
            chunks = []
        elif name is not None:
            chunks.append(line)
        else:
            raise ValueError("FASTA data before first header")
    if name is not None:
        yield FastaRecord(name, desc, "".join(chunks))


def read_fasta_encoded(file, alphabet=None):
    """Parse + lossy-encode a whole FASTA file in one native pass.

    Returns a list of ``(name, description, EncodedSequence)``; this is
    the fast data-loader path (C++ extension, GIL released), falling
    back to :func:`read_fasta` + :meth:`EncodedSequence.encode_lossy`.
    """
    import numpy as np

    from .alphabet import DNA
    from .sequence import EncodedSequence
    from . import native

    alphabet = alphabet or DNA
    mod = native.get()
    if mod is not None:
        handle = _open_text(file)
        data = handle.read().encode("ascii", errors="replace")
        records = mod.parse_fasta(
            data, alphabet.lut.tobytes(), alphabet.default_index
        )
        return [
            (
                name,
                desc,
                EncodedSequence(np.frombuffer(enc, dtype=np.uint8), alphabet),
            )
            for name, desc, enc in records
        ]
    return [
        (
            rec.name,
            rec.description,
            EncodedSequence.encode_lossy(rec.sequence, alphabet),
        )
        for rec in read_fasta(file)
    ]
