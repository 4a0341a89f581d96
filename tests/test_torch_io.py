"""The port's motif-file IO (``lightmotif_tpu_torch.io``) against the JAX
package's: the same records, read from every kind of source, give the
same motif classes, metadata and byte-equal matrices; malformed input
raises the same exception type; MEME files stream the same way."""

import gzip
import io

import numpy as np
import pytest

import lightmotif_tpu as jlm
import lightmotif_tpu.io as jio
import lightmotif_tpu_torch as tlm
import lightmotif_tpu_torch.io as tio

from .test_io import JASPAR16, JASPAR_RAW, MEME, TRANSFAC, UNIPROBE

PROTEIN_SYMBOLS = "ACDEFGHIKLMNPQRSTVWY"


def protein_texts(seed: int = 0x10) -> dict:
    """Two protein records per format (raw JASPAR is DNA only), from a
    seed."""
    rng = np.random.default_rng(seed)
    counts = [rng.integers(0, 30, size=(int(w), 20)) for w in (6, 9)]
    freqs = [c / c.sum(axis=1, keepdims=True) for c in counts]
    j16 = "".join(
        f">PF{i:05d}.1\tprotein {i}\n" + "".join(
            f"{s}  [ {' '.join(str(v) for v in c[:, k])} ]\n"
            for k, s in enumerate(PROTEIN_SYMBOLS))
        for i, c in enumerate(counts))
    transfac = "".join(
        f"ID  prot_{i}\nAC  PX{i:04d}\nDE  protein motif {i}\nDT  2024.01.0{i + 1}\n"
        f"P0  {'  '.join(PROTEIN_SYMBOLS)}\n"
        + "".join(f"{r:02d}  {'  '.join(str(v) for v in row)}  X\n"
                  for r, row in enumerate(c))
        + "XX\n//\n"
        for i, c in enumerate(counts))
    meme = (f"MEME version 5\n\nALPHABET= {PROTEIN_SYMBOLS}\n\n"
            "Background letter frequencies\n"
            + " ".join(f"{s} {1 / 20:.3f}" for s in PROTEIN_SYMBOLS[:10]) + "\n"
            + " ".join(f"{s} {1 / 20:.3f}" for s in PROTEIN_SYMBOLS[10:]) + "\n\n"
            + "".join(
                f"MOTIF p{i} PROT{i}\nletter-probability matrix: alength= 20 "
                f"w= {len(f)} nsites= 30 E= 1.5e-0{i + 3}\n"
                + "".join(" " + " ".join(f"{v:.6f}" for v in row) + "\n" for row in f)
                + "\n"
                for i, f in enumerate(freqs)))
    uniprobe = "\n".join(
        f"prot{i} primary\n" + "".join(
            f"{s}:\t" + "\t".join(f"{v:.4f}" for v in f[:, k]) + "\n"
            for k, s in enumerate(PROTEIN_SYMBOLS))
        for i, f in enumerate(freqs))
    return {"jaspar16": j16, "transfac": transfac, "meme": meme, "uniprobe": uniprobe}


PROTEIN = protein_texts()

#: (format, protein, text)
RECORDS = [
    ("jaspar", False, JASPAR_RAW),
    ("jaspar16", False, JASPAR16 + JASPAR16.replace("MA0001.3", "MA0001.4")),
    ("transfac", False, TRANSFAC),
    ("meme", False, MEME),
    ("uniprobe", False, UNIPROBE),
] + [(fmt, True, text) for fmt, text in PROTEIN.items()]

SOURCES = ["path", "bytes-path", "bytes", "text", "binary", "gzip-path", "gzip-binary",
           "data-str", "data-bytes", "loads-str", "loads-bytes"]

METADATA = {
    "JasparMotif": ("description",),
    "TransfacMotif": ("id", "accession", "description", "dates", "references", "sites"),
    "MemeMotif": ("evalue", "nsites", "url"),
    "UniprobeMotif": (),
}


def source_of(kind: str, text: str, tmp_path):
    """A callable giving a fresh (function, argument) pair for one kind
    of source: ``fn(lm)`` loads from it with package ``lm``."""
    plain = tmp_path / "motifs.txt"
    plain.write_text(text)
    packed = tmp_path / "motifs.txt.gz"
    with gzip.open(packed, "wt") as fh:
        fh.write(text)
    return {
        "path": lambda lm, **kw: lm.load(str(plain), **kw),
        "bytes-path": lambda lm, **kw: lm.load(str(plain).encode(), **kw),
        "bytes": lambda lm, **kw: lm.load(text.encode(), **kw),
        "text": lambda lm, **kw: lm.load(io.StringIO(text), **kw),
        "binary": lambda lm, **kw: lm.load(io.BytesIO(text.encode()), **kw),
        "gzip-path": lambda lm, **kw: lm.load(str(packed), **kw),
        "gzip-binary": lambda lm, **kw: lm.load(io.BytesIO(packed.read_bytes()), **kw),
        "data-str": lambda lm, **kw: lm.load(data=text, **kw),
        "data-bytes": lambda lm, **kw: lm.load(data=text.encode(), **kw),
        "loads-str": lambda lm, **kw: lm.io.loads(text, **kw),
        "loads-bytes": lambda lm, **kw: lm.io.loads(text.encode(), **kw),
    }[kind]


def same_array(got, want, what):
    if want is None:
        assert got is None, what
        return
    got, want = np.asarray(got), np.asarray(want)
    assert (got.dtype, got.shape) == (want.dtype, want.shape), what
    assert got.tobytes() == want.tobytes(), what


def assert_same_motifs(got, want):
    assert len(got) == len(want) > 0
    for t, j in zip(got, want):
        kind = type(j).__name__
        assert type(t).__name__ == kind and isinstance(t, tlm.Motif)
        assert t.name == j.name
        for field in METADATA[kind]:
            assert getattr(t, field) == getattr(j, field), (kind, field)
        if kind == "MemeMotif":
            same_array(None if t.background is None else t.background.frequencies,
                       None if j.background is None else j.background.frequencies,
                       "background")
        for attr in ("counts", "pwm", "pssm"):
            a, b = getattr(t, attr), getattr(j, attr)
            same_array(None if a is None else a.data, None if b is None else b.data,
                       (kind, attr))
            if b is not None:
                assert a.alphabet.symbols == b.alphabet.symbols
        if j.pwm is not None:
            same_array(t.pwm.background.frequencies, j.pwm.background.frequencies,
                       (kind, "pwm background"))


@pytest.mark.parametrize("source", SOURCES)
@pytest.mark.parametrize("fmt,protein,text", RECORDS,
                         ids=[f"{f}-{'protein' if p else 'dna'}" for f, p, _ in RECORDS])
def test_load_matches_jax(tmp_path, fmt, protein, text, source):
    load = source_of(source, text, tmp_path)
    got = list(load(tlm, format=fmt, protein=protein))
    want = list(load(jlm, format=fmt, protein=protein))
    assert_same_motifs(got, want)
    assert all(isinstance(m, tlm.Motif) for m in tlm.Loader(
        io.StringIO(text), format=fmt, protein=protein))


def test_raw_jaspar_refuses_protein_in_both():
    for lm in (tlm, jlm):
        with pytest.raises(ValueError):
            list(lm.load(data=JASPAR_RAW, format="jaspar", protein=True))


READERS = ["read_jaspar", "read_jaspar16", "read_transfac", "read_meme", "read_uniprobe"]


@pytest.mark.parametrize("reader,fmt,text", [
    ("read_jaspar", "jaspar", JASPAR_RAW),
    ("read_jaspar16", "jaspar16", JASPAR16),
    ("read_transfac", "transfac", TRANSFAC),
    ("read_meme", "meme", MEME),
    ("read_uniprobe", "uniprobe", UNIPROBE),
])
def test_records_match_jax(reader, fmt, text):
    got = list(getattr(tio, reader)(io.StringIO(text)))
    want = list(getattr(jio, reader)(io.StringIO(text)))
    assert [type(r).__name__ for r in got] == [type(r).__name__ for r in want]
    for t, j in zip(got, want):
        for slot in type(j).__slots__:
            if slot in ("_matrix", "data", "alphabet", "background"):
                continue
            assert getattr(t, slot) == getattr(j, slot), slot
        a, b = t.matrix(), j.matrix()
        same_array(getattr(a, "data", a), getattr(b, "data", b), reader)
        if isinstance(j, jio.TransfacRecord):
            same_array(t.to_counts().data, j.to_counts().data, "to_counts")
            same_array(t.to_freq(0.25).data, j.to_freq(0.25).data, "to_freq")


#: every malformed input of tests/test_io.py (reader, text)
MALFORMED = [
    ("read_jaspar", ">M1\n1 2 3\n4 5 6\n7 8 9\n"),
    ("read_jaspar", ">M1\n1 x 3\n1 2 3\n1 2 3\n1 2 3\n"),
    ("read_jaspar16", ">MA0000.1 empty\n"),
    ("read_jaspar16", ">M\nA  1 2 3\n"),
    ("read_jaspar16", ">M\nA [ 1 2 ]\nA [ 3 4 ]\n"),
    ("read_jaspar16", ">M\nA [ 1 2 ]\nC [ 3 ]\nG [ 0 0 ]\nT [ 0 0 ]\n"),
    ("read_transfac", "ID x\nP0 A C G Z\n00 1 2 3 4\n//\n"),
    ("read_transfac", "ID x\nP0 A C G T\n00 1 2 three 4\n//\n"),
    ("read_meme", "MEME version 4\n\nMOTIF broken\n"),
    ("read_meme", "MEME version 4\n\nMOTIF trunc\n"
     "letter-probability matrix: alength= 4 w= 3 nsites= 5 E= 1e-5\n 0.25 0.25 0.25 0.25\n"),
    ("read_meme", "MEME version 4\n\nMOTIF wide\nletter-probability matrix: alength= 4 w= 1\n"
     " 0.1 0.1 0.1 0.1 0.1 0.1 0.1\n"),
    ("read_uniprobe", "name\nA:\t0.1\tbad\n"),
]


def raised(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 - the type is what is compared
        return type(e).__name__
    return None


@pytest.mark.parametrize("reader,text", MALFORMED)
def test_malformed_input_raises_the_same_type(reader, text):
    got = raised(lambda: list(getattr(tio, reader)(io.StringIO(text))))
    want = raised(lambda: list(getattr(jio, reader)(io.StringIO(text))))
    assert got == want == "ParseError"
    assert issubclass(tio.ParseError, ValueError)
    fmt = reader[len("read_"):]
    assert raised(lambda: list(tlm.load(data=text, format=fmt))) == raised(
        lambda: list(jlm.load(data=text, format=fmt)))


@pytest.mark.parametrize("call", [
    lambda lm: lm.load(b"no_such_motif_file.jaspar"),
    lambda lm: lm.load(io.StringIO(JASPAR16), data=JASPAR16),
    lambda lm: lm.load(),
    lambda lm: lm.load(data=JASPAR16, format="nope"),
    lambda lm: lm.load(12),
])
def test_load_errors_raise_the_same_type(call):
    got = raised(lambda: list(call(tlm)))
    assert got is not None and got == raised(lambda: list(call(jlm)))


def test_meme_streams_like_jax():
    for lm_io in (tio, jio):
        handle = io.StringIO(MEME)
        f = lm_io.read_meme(handle)
        assert f.version == "4"
        first = next(iter(f))
        assert first.id == "crp"
        assert "0.857143" in handle.read()  # lexA is still unread


@pytest.mark.parametrize("step", ["records", "iter"])
def test_meme_partial_iteration_raises_like_jax(step):
    outcomes = []
    for lm_io in (tio, jio):
        f = lm_io.read_meme(io.StringIO(MEME))
        next(iter(f))
        outcomes.append(raised(lambda: f.records if step == "records" else iter(f)))
    assert outcomes == ["RuntimeError", "RuntimeError"]


def test_meme_materialized_records_replay_like_jax():
    ids = []
    for lm_io in (tio, jio):
        f = lm_io.read_meme(io.StringIO(MEME))
        assert len(f) == 2
        ids.append(([r.id for r in f], [r.id for r in f],
                    [r.id for r in lm_io.read_meme(io.StringIO(MEME))]))
    assert ids[0] == ids[1] == (["crp", "lexA"],) * 3
