"""Streaming parsers for motif file formats.

Python re-implementations (no code shared with the reference's nom
parsers) of the five formats supported by ``lightmotif-io``:

* raw JASPAR (4 bare count lines, DNA only) -- ``jaspar/``
* JASPAR 2016 (bracketed per-symbol counts)  -- ``jaspar16/``
* TRANSFAC / PRODORIC (EMBL-style)           -- ``transfac/``
* MEME / DREME / STREME minimal motif format -- ``meme/``
* UniPROBE frequency tables                  -- ``uniprobe/``

Every ``read_*`` function accepts a text-file-like object and yields
records lazily.
"""

from __future__ import annotations

import re

import numpy as np

from ..alphabet import DNA, Alphabet, Background
from .records import (
    CountRecord,
    FrequencyRecord,
    MemeRecord,
    ParseError,
    TransfacRecord,
    _counts_from_columns,
    _freqs_from_columns,
)

__all__ = [
    "read_jaspar",
    "read_jaspar16",
    "read_transfac",
    "read_meme",
    "read_uniprobe",
]


# ---------------------------------------------------------------------------
# JASPAR (raw): optional '>' header + 4 whitespace-separated count lines
# (A, C, G, T order), DNA only.
# ---------------------------------------------------------------------------

_JASPAR_ORDER = "ACGT"


def read_jaspar(handle):
    header = None
    rows = []

    def flush():
        nonlocal header, rows
        if rows:
            if len(rows) != 4:
                raise ParseError(f"expected 4 count lines, got {len(rows)}")
            columns = dict(zip(_JASPAR_ORDER, rows))
            rec_id, desc = header if header else (None, None)
            yield CountRecord(rec_id, _counts_from_columns(DNA, columns), desc)
        header = None
        rows = []

    for line in handle:
        line = line.rstrip("\n")
        if not line.strip():
            continue
        if line.startswith(">"):
            yield from flush()
            parts = line[1:].split(None, 1)
            header = (
                parts[0] if parts else "",
                parts[1] if len(parts) > 1 else None,
            )
        else:
            if len(rows) == 4:
                yield from flush()
            try:
                rows.append([int(tok) for tok in line.split()])
            except ValueError as e:
                raise ParseError(f"bad JASPAR count line: {line!r}") from e
    yield from flush()


# ---------------------------------------------------------------------------
# JASPAR 2016: '>' header + per-symbol bracketed count lines.
# ---------------------------------------------------------------------------

_J16_LINE = re.compile(r"^\s*(\S)\s*\[\s*([^\]]*)\]\s*$")


def read_jaspar16(handle, alphabet: Alphabet = DNA):
    header = None
    columns = {}

    def flush():
        nonlocal header, columns
        if header is not None:
            if not columns:
                raise ParseError(f"record {header[0]!r} has no matrix")
            yield CountRecord(
                header[0], _counts_from_columns(alphabet, columns), header[1]
            )
        header = None
        columns = {}

    for line in handle:
        line = line.rstrip("\n")
        if not line.strip():
            continue
        if line.startswith(">"):
            yield from flush()
            parts = line[1:].split(None, 1)
            header = (
                parts[0] if parts else "",
                parts[1].strip() if len(parts) > 1 else None,
            )
        else:
            m = _J16_LINE.match(line)
            if not m:
                raise ParseError(f"bad JASPAR16 line: {line!r}")
            sym = m.group(1).upper()
            if sym in columns:
                raise ParseError(f"duplicate symbol {sym!r}")
            try:
                columns[sym] = [int(t) for t in m.group(2).split()]
            except ValueError as e:
                raise ParseError(f"bad counts in line: {line!r}") from e
    yield from flush()


# ---------------------------------------------------------------------------
# TRANSFAC: EMBL-style two-letter codes, '//' record terminator, 'P0'
# matrix header declaring the per-file symbol column order.
# ---------------------------------------------------------------------------


def read_transfac(handle, alphabet: Alphabet = DNA):
    fields = {}
    matrix_order = None
    matrix_rows = []
    seen_any = False

    def flush():
        nonlocal fields, matrix_order, matrix_rows, seen_any
        if seen_any:
            data = None
            if matrix_rows:
                n = len(matrix_rows)
                data = np.zeros((n, alphabet.size), dtype=np.float32)
                for i, row in enumerate(matrix_rows):
                    for sym, val in zip(matrix_order, row):
                        data[i, alphabet.symbols.index(sym)] = val
            yield TransfacRecord(
                alphabet,
                data,
                id=fields.get("ID"),
                accession=fields.get("AC"),
                name=fields.get("NA"),
                description=fields.get("DE"),
                dates=fields.get("DT", []),
                references=fields.get("RN", []),
                sites=fields.get("BS", []),
            )
        fields = {}
        matrix_order = None
        matrix_rows = []
        seen_any = False

    in_matrix = False
    for line in handle:
        line = line.rstrip("\n")
        if not line.strip():
            continue
        code = line[:2]
        rest = line[2:].strip()
        if code == "//":
            in_matrix = False
            yield from flush()
            continue
        seen_any = True
        if code == "XX":
            in_matrix = False
            continue
        if code in ("P0", "PO"):
            matrix_order = rest.split()
            for sym in matrix_order:
                if sym not in alphabet.symbols:
                    raise ParseError(f"unknown symbol {sym!r} in P0 header")
            in_matrix = True
            continue
        if in_matrix and code.isdigit():
            tokens = rest.split()
            # last token may be the consensus letter
            vals = []
            for tok in tokens[: len(matrix_order)]:
                try:
                    vals.append(float(tok))
                except ValueError:
                    break
            if len(vals) != len(matrix_order):
                raise ParseError(f"bad matrix row: {line!r}")
            matrix_rows.append(vals)
            continue
        in_matrix = False
        if code in ("DT", "BS", "RN", "RA", "RT", "RL", "RX"):
            key = "DT" if code == "DT" else ("BS" if code == "BS" else "RN")
            fields.setdefault(key, []).append(rest)
        elif code in ("ID", "AC", "NA", "DE"):
            fields[code] = rest
        # other codes (BF, CO, CC, ...) are ignored, like the reference
    yield from flush()


# ---------------------------------------------------------------------------
# MEME minimal motif format.
# ---------------------------------------------------------------------------

_MEME_VERSION = re.compile(r"^MEME version\s+(.*?)\s*$")
_MEME_MOTIF = re.compile(r"^MOTIF\s+(\S+)(?:\s+(\S+))?")
_MEME_LPM = re.compile(
    r"^letter-probability matrix:"
    r"(?:\s+alength=\s*(\d+))?(?:\s+w=\s*(\d+))?"
    r"(?:\s+nsites=\s*(\S+))?(?:\s+E=\s*(\S+))?"
)
_MEME_URL = re.compile(r"^URL\s+(\S+)")
_NUM = re.compile(r"[-+]?\d*\.?\d+(?:[eE][-+]?\d+)?")


class MemeFile:
    """Parsed MEME file.

    ``version`` / ``background`` come from the eagerly-parsed prologue;
    motif records **stream lazily** (like the reference's nom reader,
    ``lightmotif-io/src/meme/parse.rs``): iterating the file -- which is
    what ``load()`` does -- reads one motif at a time in constant
    memory, so multi-megabyte databases (JASPAR2024.meme) never
    materialize.  Touching ``.records`` or ``len()`` drains the stream
    into a list (don't mix with partial iteration)."""

    def __init__(self, version, background, record_iter):
        self.version = version
        self.background = background
        self._iter = record_iter
        self._records = None
        self._consumed = False

    @property
    def records(self):
        if self._records is None:
            if self._consumed:
                # materializing now would silently drop the records the
                # caller already consumed from the stream
                raise RuntimeError(
                    "MemeFile records were partially consumed by "
                    "iteration; materialize .records (or len()) before "
                    "iterating, or re-read the file")
            self._records = list(self._iter)
        return self._records

    def __iter__(self):
        if self._records is not None:
            return iter(self._records)
        if self._consumed:
            # a second pass over the shared stream would silently skip
            # the motifs the first (partial) pass already consumed
            raise RuntimeError(
                "MemeFile was already partially iterated; materialize "
                ".records (or len()) before iterating, or re-read the "
                "file")

        def stream():
            first = True
            while True:
                if first and self._records is not None:
                    # .records / len() materialized before the first
                    # pull (list() probes __len__ as a length hint)
                    yield from self._records
                    return
                try:
                    rec = next(self._iter)
                except StopIteration:
                    return
                first = False
                self._consumed = True
                yield rec

        return stream()

    def __len__(self):
        return len(self.records)


def _parse_meme_background(lines, alphabet):
    """Symbol/frequency pairs, possibly spanning several lines; returns
    (background, first unconsumed line)."""
    toks = []
    while True:
        line = next(lines, None)
        if line is None:
            break
        parts = line.strip().split()
        if not parts or len(parts) % 2 != 0 or not _NUM.fullmatch(parts[1]):
            break
        toks.extend(parts)
    freqs = np.zeros(alphabet.size, dtype=np.float32)
    for sym, val in zip(toks[::2], toks[1::2]):
        freqs[alphabet.symbols.index(sym)] = float(val)
    return Background(alphabet, freqs, _validate=False), line


def _meme_motifs(lines, first, alphabet, symbols, background):
    """Lazily yield MemeRecords starting from the ``first`` line."""
    from ..matrix import FrequencyMatrix

    pending = first
    while True:
        line = pending if pending is not None else next(lines, None)
        pending = None
        if line is None:
            return
        m = _MEME_MOTIF.match(line.strip())
        if not m:
            continue
        rec_id, rec_name = m.group(1), m.group(2)
        alength = w = nsites = evalue = url = None
        rows = []
        # scan forward for the letter-probability matrix
        for line2 in lines:
            s2 = line2.strip()
            lpm = _MEME_LPM.match(s2)
            if lpm:
                alength = int(lpm.group(1)) if lpm.group(1) else None
                w = int(lpm.group(2)) if lpm.group(2) else None
                nsites = int(float(lpm.group(3))) if lpm.group(3) else None
                evalue = float(lpm.group(4)) if lpm.group(4) else None
                break
        else:
            raise ParseError(f"motif {rec_id!r} has no matrix")
        # matrix rows follow until a non-numeric line
        for line2 in lines:
            s2 = line2.strip()
            if not s2:
                if rows:
                    break
                continue
            toks = s2.split()
            if all(_NUM.fullmatch(t) for t in toks):
                rows.append([float(t) for t in toks])
                if w is not None and len(rows) == w:
                    break
            else:
                pending = line2
                break
        if w is not None and len(rows) != w:
            raise ParseError(
                f"motif {rec_id!r}: truncated matrix "
                f"({len(rows)} of {w} rows)"
            )
        # optional URL line
        while True:
            line2 = pending if pending is not None else next(lines, None)
            pending = None
            if line2 is None:
                break
            s2 = line2.strip()
            if not s2:
                continue
            mu = _MEME_URL.match(s2)
            if mu:
                url = mu.group(1)
            else:
                pending = line2
            break
        k = alphabet.size
        data = np.zeros((len(rows), k), dtype=np.float32)
        for i, row in enumerate(rows):
            if len(row) > k - 1 and len(row) != k:
                raise ParseError(
                    f"motif {rec_id!r}: row has {len(row)} values"
                )
            # MEME column order follows the declared ALPHABET=
            # (ACGT for DNA), not our internal order
            order = symbols or alphabet.symbols[: len(row)]
            for sym, val in zip(order, row):
                data[i, alphabet.symbols.index(sym)] = val
        yield MemeRecord(
            rec_id,
            FrequencyMatrix(alphabet, data, _validate=False),
            name=rec_name,
            alength=alength,
            w=w,
            nsites=nsites,
            evalue=evalue,
            url=url,
            background=background,
        )


def read_meme(handle, alphabet: Alphabet = DNA) -> MemeFile:
    """Parse the prologue (version / ALPHABET= / background) eagerly,
    stopping at the first MOTIF line; motifs stream lazily."""
    version = None
    background = None
    symbols = None
    lines = iter(handle)

    pending = None
    while True:
        line = pending if pending is not None else next(lines, None)
        pending = None
        if line is None:
            break
        stripped = line.strip()
        m = _MEME_VERSION.match(stripped)
        if m:
            version = m.group(1)
            continue
        if stripped.startswith("ALPHABET="):
            symbols = stripped.split("=", 1)[1].strip()
            continue
        if stripped.startswith("Background letter frequencies"):
            background, pending = _parse_meme_background(lines, alphabet)
            continue
        if _MEME_MOTIF.match(stripped):
            break
    return MemeFile(
        version, background,
        _meme_motifs(lines, line, alphabet, symbols, background),
    )


# ---------------------------------------------------------------------------
# UniPROBE: name line + per-symbol 'A:\t...' frequency lines.
# ---------------------------------------------------------------------------

_UNIPROBE_LINE = re.compile(r"^\s*(\S)\s*:\s*(.*)$")


def read_uniprobe(handle, alphabet: Alphabet = DNA):
    name = None
    columns = {}

    def flush():
        nonlocal name, columns
        if name is not None and columns:
            yield FrequencyRecord(name, _freqs_from_columns(alphabet, columns))
        name = None
        columns = {}

    for line in handle:
        line = line.rstrip("\n")
        if not line.strip():
            yield from flush()
            continue
        m = _UNIPROBE_LINE.match(line)
        if m and m.group(1).upper() in alphabet.symbols and columns is not None:
            try:
                values = [float(t) for t in m.group(2).split()]
            except ValueError as e:
                raise ParseError(f"bad UniPROBE line: {line!r}") from e
            sym = m.group(1).upper()
            if sym in columns:
                # a new record started without a blank separator
                yield from flush()
                name = None
            columns[sym] = values
        else:
            if columns:
                yield from flush()
            name = line.strip()
    yield from flush()
