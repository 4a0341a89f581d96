"""The port's FIMO-like CLI (``lightmotif_tpu_torch.cli``) against the JAX
package's: on the inputs of ``tests/test_cli.py`` (``--mesh`` included)
and on a protein motif file, both write byte-identical TSVs.  The port
runs on the CPU, chosen explicitly; the JAX CLI runs as
``tests/test_cli.py`` runs it (``--mesh`` on its 8 virtual devices)."""

import gzip
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from lightmotif_tpu.cli import main as jax_main
from lightmotif_tpu_torch import cli
from lightmotif_tpu_torch.ops import build

from .test_cli import FASTA, MATRICES
from .test_io import MEME
from .test_torch_io import PROTEIN
from .torch_parity import cpu_choice  # noqa: F401  (a fixture)

ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def keep_build_dir(monkeypatch):
    """``--no-compile-cache`` chooses a temporary build directory for the
    process; give the next test the directory it had.  (Both CLIs run
    with ``LIGHTMOTIF_TPU_COMPILE_CACHE=off``, set by ``torch_parity``.)"""
    assert os.environ.get(build.ENV) == "off"
    monkeypatch.setattr(build, "_DIR", build._DIR)


def random_dna(rng, n: int) -> str:
    return "".join("ACGT"[c] for c in rng.integers(0, 4, size=n))


def inputs(tmp_path, case: str):
    """The motif file, FASTA file and extra arguments of one case, written
    as ``tests/test_cli.py`` writes them."""
    m = tmp_path / "motifs.jaspar16"
    m.write_text(MATRICES)
    s = tmp_path / "seqs.fa"
    s.write_text(FASTA)
    fmt = ["--format", "jaspar16"]
    if case == "gzip":
        m = tmp_path / "motifs.gz"
        with gzip.open(m, "wt") as fh:
            fh.write(MATRICES)
        s = tmp_path / "seqs.fa.gz"
        with gzip.open(s, "wt") as fh:
            fh.write(FASTA)
    elif case in ("batched", "batched-serial"):
        rng = np.random.default_rng(12)
        recs = [f">rec{i}\n{random_dna(rng, 120)}\n" for i in range(12)]
        s.write_text(recs[5] if case == "batched-serial" else "".join(recs))
    elif case == "no-direct":
        rng = np.random.default_rng(3)
        s.write_text("".join(f">r{i}\n" + random_dna(rng, 60) + "\n" for i in range(12)))
    elif case == "flights":
        rng = np.random.default_rng(17)
        recs = []
        for i in range(40):
            body = random_dna(rng, 400)
            if i % 7 == 0:
                body = body[:100] + "GTTGACCTTATCAAC" + body[115:]
            recs.append(f">r{i}\n{body}\n")
        s.write_text("".join(recs))
    elif case == "solo":
        rng = np.random.default_rng(23)
        big = random_dna(rng, 9000)
        big = big[:500] + "GTTGACCTTATCAAC" + big[515:]
        small = random_dna(rng, 300)
        s.write_text(f">small1\n{small}\n>big\n{big}\n>small2\n{small}\n")
    elif case == "protein":
        m = tmp_path / "protein.jaspar16"
        m.write_text(PROTEIN["jaspar16"])
        rng = np.random.default_rng(5)
        letters = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
        s.write_text("".join(f">p{i} protein record\n"
                             + "".join(rng.choice(letters, int(rng.integers(20, 900))))
                             + ("BZ\n" if i == 2 else "\n") for i in range(11)))
        fmt = ["--format", "jaspar16", "--protein"]
    elif case == "meme":
        m = tmp_path / "motifs.meme"
        m.write_text(MEME)
        rng = np.random.default_rng(9)
        s.write_text("".join(f">m{i}\n{random_dna(rng, 200)}\n" for i in range(9)))
        fmt = ["--format", "meme"]
    return ["-m", str(m), *fmt, "-s", str(s)]


#: (case, extra arguments): the cases of tests/test_cli.py but --mesh, then
#: the default threshold, a MEME file and a protein motif file
CASES = [
    ("planted", ["--abs-threshold", "-10"]),
    ("planted", ["-P", "1e-4"]),
    ("planted", ["--abs-threshold", "-10", "--reverse"]),
    ("planted", ["--rel-threshold", "0.8"]),
    ("gzip", ["--abs-threshold", "-10"]),
    ("batched", ["--abs-threshold", "-14", "--reverse"]),
    ("batched-serial", ["--abs-threshold", "-14", "--reverse"]),
    ("no-direct", ["--no-direct"]),
    ("flights", ["--abs-threshold", "-8", "--flight-bytes", "2048"]),
    ("flights", ["--abs-threshold", "-8", "--flight-bytes", str(1 << 26)]),
    ("solo", ["--abs-threshold", "-8", "--flight-bytes", "4096"]),
    ("solo", ["--abs-threshold", "-8", "--flight-bytes", str(1 << 26)]),
    ("planted", []),
    ("planted", ["--abs-threshold", "-10", "--block-size", "7", "-j", "4",
                 "--no-compile-cache"]),
    ("meme", ["--abs-threshold", "0", "--reverse"]),
    ("protein", ["-P", "1e-3"]),
    ("protein", ["--abs-threshold", "0", "--flight-bytes", "1500"]),
]


def run(main, args, out) -> str:
    assert main([*args, "-o", str(out), "-q"]) == 0
    return out.read_text()


@pytest.mark.parametrize("case,extra", CASES,
                         ids=[f"{c}-{'_'.join(e) or 'default'}" for c, e in CASES])
def test_tsv_is_byte_identical_to_the_jax_cli(cpu_choice, tmp_path, case, extra):  # noqa: F811
    args = inputs(tmp_path, case) + extra
    got = run(cli.main, args, tmp_path / "port.tsv")
    jax_args = [a for a in args if a != "--no-compile-cache"]
    want = run(jax_main, jax_args, tmp_path / "jax.tsv")
    assert got == want
    assert got.startswith("seq_index\tseq_name\tmotif_index\tmotif_name\tpos\tstrand\t"
                          "score\tpvalue\n")
    if case not in ("no-direct",):
        assert got.count("\n") > 1  # hits were found


def test_flights_match_one_pass(cpu_choice, tmp_path):  # noqa: F811
    """Many bounded flights (the reader thread, one flight in flight) give
    the one-pass TSV, as tests/test_cli.py requires of the JAX CLI."""
    args = inputs(tmp_path, "flights") + ["--abs-threshold", "-8"]
    streamed = run(cli.main, args + ["--flight-bytes", "2048"], tmp_path / "a.tsv")
    single = run(cli.main, args + ["--flight-bytes", str(1 << 26)], tmp_path / "b.tsv")
    assert streamed == single and streamed.count("\n") > 5


def test_stderr_progress_and_timing(cpu_choice, tmp_path, capsys):  # noqa: F811
    import json

    args = inputs(tmp_path, "flights") + ["--abs-threshold", "-8", "--flight-bytes", "2048"]
    assert cli.main([*args, "-o", str(tmp_path / "o.tsv")]) == 0
    err = capsys.readouterr().err.splitlines()
    assert "loaded 1 matrices (M=15..15)" in err[0]
    assert err[-2].endswith(f"40 sequences, {(tmp_path / 'o.tsv').read_text().count(chr(10)) - 1}"
                            " hits")
    timing = json.loads(err[-1])
    assert set(timing) == {"event", "startup_s", "steady_s", "steady_mbp_s", "imports_s",
                           "device_init_s", "prep_s"}
    assert timing["event"] == "cli_timing"


#: (case, extra arguments) of the --mesh runs: one strand (ShardedScanner),
#: both strands (ShardedMultiScanner), many records, a MEME file
MESH_CASES = [
    ("planted", ["--abs-threshold", "-12"]),
    ("planted", ["--abs-threshold", "-10", "--reverse"]),
    ("batched", ["--abs-threshold", "-14", "--reverse"]),
    ("solo", ["--abs-threshold", "-8", "--flight-bytes", "4096"]),
    ("meme", ["--abs-threshold", "0", "--reverse"]),
]


@pytest.mark.parametrize("shards", [None, 3], ids=["default-mesh", "3-shards"])
@pytest.mark.parametrize("case,extra", MESH_CASES,
                         ids=[f"{c}-{'_'.join(e)}" for c, e in MESH_CASES])
def test_mesh_matches_single(cpu_choice, tmp_path, monkeypatch, case, extra,  # noqa: F811
                             shards):
    """The --mesh case of tests/test_cli.py: the port's --mesh rows equal
    its solo rows, and its --mesh TSV is byte-identical to the JAX CLI's
    --mesh TSV (and so to both solo TSVs, whose rows come in the same
    order)."""
    from lightmotif_tpu_torch.parallel import mesh

    if shards is not None:
        default = mesh.make_genome_mesh
        monkeypatch.setattr(mesh, "make_genome_mesh",
                            lambda devices=None: default(devices or ["cpu"] * shards))
    args = inputs(tmp_path, case) + extra
    got = run(cli.main, args + ["--mesh"], tmp_path / "mesh.tsv")
    solo = run(cli.main, args, tmp_path / "solo.tsv")
    key = lambda r: (r[0], r[2], int(r[4]), r[5])  # noqa: E731
    rows = lambda text: sorted(map(key, (line.split("\t")  # noqa: E731
                                         for line in text.splitlines()[1:])))
    assert rows(got) == rows(solo) and got.count("\n") > 1
    assert got == run(jax_main, args + ["--mesh"], tmp_path / "jax.tsv")
    assert got == solo


def test_no_device_is_refused_without_a_choice(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = inputs(tmp_path, "planted") + ["--abs-threshold", "-10"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main([*args, "-o", str(tmp_path / "o.tsv"), "-q"])
    assert not (tmp_path / "o.tsv").exists()


WRAPPER = """\
import runpy, sys
from lightmotif_tpu_torch.ops.pipeline import use_device
use_device("cpu")
sys.argv[0] = "lightmotif_tpu_torch.cli"
try:
    runpy.run_module("lightmotif_tpu_torch.cli", run_name="__main__", alter_sys=True)
except SystemExit as e:
    bad = sorted(m for m in sys.modules
                 if m.split(".")[0] in ("jax", "jaxlib", "lightmotif_tpu"))
    assert not bad, bad
    raise
"""


def test_module_run_imports_neither_jax_nor_the_jax_package(tmp_path):
    args = inputs(tmp_path, "batched") + ["--abs-threshold", "-14", "--reverse"]
    out = tmp_path / "port.tsv"
    proc = subprocess.run(
        [sys.executable, "-c", WRAPPER, *args, "-o", str(out)], cwd=tmp_path,
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert proc.returncode == 0, proc.stderr
    assert '"event": "cli_timing"' in proc.stderr
    assert out.read_text() == run(jax_main, args, tmp_path / "jax.tsv")
