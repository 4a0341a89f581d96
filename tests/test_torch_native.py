"""The port's native host runtime (``lightmotif_tpu_torch.native``): built
with the C++ compiler into the kernels' build directory, byte-equal to
the port's NumPy path and to the JAX package, with and without the
native module."""

import gzip
import io
import os
import pathlib

import numpy as np
import pytest

import lightmotif_tpu as jlm
import lightmotif_tpu_torch as tlm
from lightmotif_tpu import native as jnative
from lightmotif_tpu.fasta import read_fasta_encoded as jax_read_fasta_encoded
from lightmotif_tpu_torch import fasta as tfasta
from lightmotif_tpu_torch import native
from lightmotif_tpu_torch.ops import build


def native_dir():
    return pathlib.Path(native.__file__).parent / "_native"


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The native module, built once with the C++ compiler into a build
    directory of this module's own (the resolved build directory)."""
    directory = tmp_path_factory.mktemp("build")
    saved = build._DIR, native._MODULE, native._FAILED
    build._DIR, native._MODULE, native._FAILED = directory, None, False
    try:
        mod = native.get()
    finally:
        build._DIR, native._MODULE, native._FAILED = saved
    return mod, directory


def test_native_builds_into_the_build_directory(built):
    mod, directory = built
    assert mod is not None
    assert all(hasattr(mod, f) for f in ("encode", "parse_fasta", "count_symbols"))
    assert [p.name.startswith("_lightmotif_native-") and p.suffix == ".so"
            for p in directory.iterdir()] == [True]
    assert not list(native_dir().glob("*.so"))  # nothing beside the source


@pytest.fixture(params=["native", "numpy"])
def path(request, built, monkeypatch, tmp_path):
    """The port's encoder through the native module, or through NumPy
    after a build that fails (``CXX`` names a missing compiler)."""
    monkeypatch.setattr(native, "_FAILED", False)
    if request.param == "numpy":
        monkeypatch.setattr(native, "_MODULE", None)
        monkeypatch.setattr(build, "_DIR", tmp_path)
        monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
        assert native.get() is None
        assert list(tmp_path.iterdir()) == []
    else:
        monkeypatch.setattr(native, "_MODULE", built[0])
    return request.param


def seeded_text(seed: int, symbols: str, n: int) -> str:
    rng = np.random.default_rng(seed)
    return "".join(rng.choice(list(symbols), size=n))


CASES = [  # (alphabet name, text symbols, strict-encodable)
    ("DNA", "ACGTN", True),
    ("DNA", "ACGTNacgt?-", False),
    ("PROTEIN", "ACDEFGHIKLMNPQRSTVWYX", True),
    ("PROTEIN", "ACDEFGHIKLMNPQRSTVWYXBZ*u", False),
]


@pytest.mark.parametrize("name,symbols,strict", CASES)
def test_encode_is_byte_equal_to_numpy_and_jax(path, name, symbols, strict):
    text = seeded_text(len(symbols), symbols, 10_000)
    talpha, jalpha = getattr(tlm, name), getattr(jlm, name)
    numpy_lossy = talpha.lut[np.frombuffer(text.encode(), np.uint8)]
    numpy_lossy = np.where(numpy_lossy == 255, talpha.default_index, numpy_lossy)
    lossy = tlm.EncodedSequence.encode_lossy(text, talpha)
    assert lossy.data.tobytes() == numpy_lossy.astype(np.uint8).tobytes()
    assert lossy.data.tobytes() == jlm.EncodedSequence.encode_lossy(text, jalpha).data.tobytes()
    if strict:
        strict_t = tlm.EncodedSequence.encode(text, talpha)
        assert strict_t.data.tobytes() == lossy.data.tobytes()
        assert strict_t.data.tobytes() == jlm.EncodedSequence.encode(text, jalpha).data.tobytes()
    else:
        with pytest.raises(tlm.InvalidSymbolError) as e:
            tlm.EncodedSequence.encode(text, talpha)
        with pytest.raises(jlm.InvalidSymbolError) as j:
            jlm.EncodedSequence.encode(text, jalpha)
        assert e.value.char == j.value.char
    counts = lossy.count_symbols()
    assert counts.dtype == np.int64
    assert counts.tolist() == np.bincount(lossy.data, minlength=talpha.size).tolist()
    assert counts.tolist() == jlm.EncodedSequence(lossy.data, jalpha).count_symbols().tolist()


def fasta_text(seed: int, symbols: str, records: int = 6) -> str:
    rng = np.random.default_rng(seed)
    parts = []
    for i in range(records):
        body = seeded_text(seed + i, symbols, int(rng.integers(0, 3000)))
        desc = f" record {i}\tdesc" if i % 2 else ""
        parts.append(f">r{i}{desc}\n")
        for j in range(0, len(body), 61):
            parts.append(body[j : j + 61] + ("\r\n" if i == 3 else "\n"))
        if i == 4:
            parts.append("\n")
    return "".join(parts)


@pytest.mark.parametrize("name,symbols", [("DNA", "ACGTNacgt?"), ("PROTEIN", "ACDEFGHIKLMXz")])
@pytest.mark.parametrize("form", ["path", "gzip", "text", "binary"])
def test_read_fasta_encoded_equals_read_fasta_and_jax(path, tmp_path, name, symbols, form):
    text = fasta_text(7, symbols)
    plain = tmp_path / "r.fa"
    plain.write_text(text)
    packed = tmp_path / "r.fa.gz"
    with gzip.open(packed, "wt") as fh:
        fh.write(text)
    source = {"path": lambda: str(plain), "gzip": lambda: str(packed),
              "text": lambda: io.StringIO(text),
              "binary": lambda: io.BytesIO(text.encode())}[form]
    talpha, jalpha = getattr(tlm, name), getattr(jlm, name)
    got = tfasta.read_fasta_encoded(source(), talpha)
    slow = [(r.name, r.description, tlm.EncodedSequence.encode_lossy(r.sequence, talpha))
            for r in tfasta.read_fasta(source())]
    want = jax_read_fasta_encoded(source(), jalpha)
    assert len(got) == len(slow) == len(want) == 6
    for (n, d, s), (n2, d2, s2), (n3, d3, s3) in zip(got, slow, want):
        assert (n, d) == (n2, d2) == (n3, d3)
        assert s.data.tobytes() == s2.data.tobytes() == s3.data.tobytes()
        assert s.alphabet is talpha


def test_read_fasta_matches_jax_read_fasta(path, tmp_path):
    from lightmotif_tpu.fasta import read_fasta as jax_read_fasta

    text = fasta_text(3, "ACGTN")
    got = [(r.name, r.description, r.sequence) for r in tfasta.read_fasta(io.StringIO(text))]
    want = [(r.name, r.description, r.sequence) for r in jax_read_fasta(io.StringIO(text))]
    assert got == want
    with pytest.raises(ValueError):
        list(tfasta.read_fasta(io.StringIO("ACGT\n>r\nACGT\n")))


def test_jax_native_is_the_same_source():
    src = os.path.join(os.path.dirname(jnative.__file__), "_native", "lightmotif_native.cpp")
    ours = native_dir() / "lightmotif_native.cpp"
    body = lambda text: text[text.index("#define PY_SSIZE_T_CLEAN"):]  # noqa: E731
    assert body(ours.read_text()) == body(open(src).read())
