"""The proteome cell (``human.proteome-p1e-4``): its configuration's
shapes, and a traced run of the tiny protein cell on the CPU that reads
the record set's host work and upload from the program's spans."""

import json
import time

import numpy as np
import pytest

from tiny_cell import PROTEIN, REPO, make_protein_root
from motifbench import data, harness

CONF = json.loads((REPO / "motifbench/configs/prints42-human.json").read_text())


def test_the_database_is_prints_sized_with_its_length_bands():
    lengths = data.profile_lengths(CONF["database"])
    assert lengths.size == 12444 and CONF["database"]["strands"] == 1
    bands = {(6, 9): 996, (10, 14): 3111, (15, 20): 4355, (21, 25): 2240, (26, 32): 1244,
             (33, 40): 498}
    for (lo, hi), n in bands.items():
        assert int(((lengths >= lo) & (lengths <= hi)).sum()) == n
    assert "complement" not in CONF and CONF["alphabet"] == "ACDEFGHIKLMNPQRSTVWYX"


def test_a_batch_is_a_quarter_of_the_proteome():
    lengths = data.mix_lengths(CONF["sequence"]["records"])
    assert lengths.size == 5167 and int(lengths.sum()) == 2_902_500
    assert np.median(lengths) == 400 and lengths.max() == 34350
    assert CONF["sequence"]["composition"] == "background"


def test_the_background_is_a_program_background():
    from lightmotif_tpu_torch import PROTEIN as ALPHABET, Background

    freqs = np.asarray(CONF["database"]["background"], np.float32)
    assert freqs[-1] == 0 and (freqs[:-1] > 0).all()
    Background(ALPHABET, freqs)  # its float32 sum is 1


@pytest.fixture
def cpu():
    from lightmotif_tpu_torch.ops.pipeline import use_device

    use_device("cpu")
    yield
    use_device(None)


def test_a_record_set_reads_its_join_upload_and_mapping(tmp_path, cpu):
    root = make_protein_root(tmp_path)
    res = harness.run(root, PROTEIN, 2**31 + 47, 0.3, True, t_start=time.perf_counter(),
                      device="cpu", bench=root, log=lambda *a: None)
    assert res["correct"], res["checks"]
    got = res["metrics"]
    assert got["records.host_ms_per_scan"]["value"] > 0
    assert got["upload.host_ms_per_scan"]["value"] > 0
    for name in ("dense.ms_per_scan", "dense.roofline_pct", "prefilter.deep_share"):
        assert name not in got  # no device operation, no warpgroup launch on the CPU
