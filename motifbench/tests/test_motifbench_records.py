"""Whole runs on the CPU of the tiny cells that scan record sets, past
the harness's look for a card: DNA record sets on both strands and on
one, and a protein database on one strand against a non-uniform
background, some of its motifs on the program's dense path.  A sound
run is correct; the control (the reference in bfloat16 in the program's
place) and faults planted under the timed path are not."""

import time

import numpy as np
import pytest

from tiny_cell import PROTEIN, RECORDS, make_protein_root, make_records_root
from motifbench import harness

CELLS = {"dna": (RECORDS, lambda p: make_records_root(p)),
         "dna-one-strand": (RECORDS, lambda p: make_records_root(p, strands=1)),
         "protein": (PROTEIN, make_protein_root)}


@pytest.fixture
def cpu():
    from lightmotif_tpu_torch.ops.pipeline import use_device

    use_device("cpu")
    yield
    use_device(None)


def run_cell(tmp_path, cell, seed, **kw):
    workload, make = CELLS[cell]
    root = make(tmp_path)
    return harness.run(root, workload, seed, 0.3, kw.pop("trace", False),
                       t_start=time.perf_counter(), device="cpu", bench=root,
                       log=lambda *a: None, **kw)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_sound_run_is_correct_and_the_control_is_not(tmp_path, cpu, cell):
    res = run_cell(tmp_path, cell, 2**31 + 41, control=True)
    assert res["correct"] and res["failed"] == 0, res["checks"]
    limits = {k: v["limit"] for k, v in res["checks"].items()}
    assert not harness.check.verdict(res["control"], limits), res["control"]


def test_protein_run_takes_both_paths_and_reads_its_metrics(tmp_path, cpu):
    from lightmotif_tpu_torch.scanner import MultiScanner

    assert MultiScanner.dense_m_limit(21) < 40  # the longest motifs go dense
    res = run_cell(tmp_path, "protein", 2**31 + 43, trace=True)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert got["fetch.reads_per_scan"]["value"] == 1
    assert got["exact.candidates_per_scan"]["value"] > 0
    assert "upload.host_ms_per_scan" not in got  # a set's upload opens no scan
    assert "prefilter.roofline_pct" not in got  # no device operation on the CPU


def strongest(rec, sc, ok):
    """The index of the highest-scoring hit among ``ok``."""
    return int(np.flatnonzero(ok)[np.argmax(sc[ok])])


def moved_to_the_next_record(self, out):
    rec, mo, local, sc = (a.copy() for a in out)
    i = strongest(rec, sc, rec < len(self._lengths) - 1)
    rec[i] += 1
    return rec, mo, local, sc


def crossing_the_records_end(self, out):
    rec, mo, local, sc = (a.copy() for a in out)
    i = strongest(rec, sc, np.ones(len(rec), bool))
    local[i] = self._lengths[rec[i]] - self._m[mo[i]] + 1
    return rec, mo, local, sc


def dropped(self, out):
    keep = np.arange(len(out[0])) != strongest(out[0], out[3], np.ones(len(out[0]), bool))
    return tuple(a[keep] for a in out)


@pytest.mark.parametrize("fault", [moved_to_the_next_record, crossing_the_records_end,
                                   dropped])
@pytest.mark.parametrize("cell", ["dna", "protein"])
def test_faults_under_the_timed_path_are_not_correct(tmp_path, cpu, monkeypatch, cell,
                                                     fault):
    from lightmotif_tpu_torch.batch import MultiBatchScanner

    real = MultiBatchScanner.collect_arrays
    calls = []

    def collect_arrays(self):  # set-up's one scan of each set stays sound
        calls.append(1)
        out = real(self)
        return fault(self, out) if len(calls) > 4 else out

    monkeypatch.setattr(MultiBatchScanner, "collect_arrays", collect_arrays)
    res = run_cell(tmp_path, cell, 2**31 + 47)
    assert len(calls) > 4
    assert not res["correct"], res["checks"]


def test_reverse_complements_for_one_strand_are_not_correct(tmp_path, cpu, monkeypatch):
    real = harness.program_chain

    def both_strands(counts, config, pvalue):
        both = dict(config, database=dict(config["database"], strands=2),
                    complement="TGACN")
        return real(counts, both, pvalue)

    monkeypatch.setattr(harness, "program_chain", both_strands)
    res = run_cell(tmp_path, "dna-one-strand", 2**31 + 53)
    checks = res["checks"]
    assert not res["correct"]
    assert checks["matrix_gap"]["value"] == float("inf")
    assert checks["extra_hits"]["value"] > 0


def test_an_alphabet_the_program_lacks_gives_no_result(tmp_path, cpu):
    import json

    root = make_protein_root(tmp_path)
    conf = json.loads((root / "configs/tiny.json").read_text())
    conf["alphabet"] = "ACGU"
    (root / "configs/tiny.json").write_text(json.dumps(conf))
    with pytest.raises(harness.NoResult, match="ACGU"):
        harness.run(root, PROTEIN, 1, 0.1, False, t_start=time.perf_counter(),
                    device="cpu", bench=root, log=lambda *a: None)
