"""On the card, at a cell's own size: a short run of each E. coli cell is
correct and its control (the reference in bfloat16 in the program's
place) is not.  Skips where there is no CUDA device."""

import time

import pytest

from tiny_cell import REPO
from motifbench import harness


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["ecoli.genomes-p1e-5", "ecoli.genomes-p1e-4"])
def test_control_fails_at_the_cells_size(card, workload):
    res = harness.run(REPO, workload, 2**31 + 101, 2.0, False,
                      t_start=time.perf_counter(), control=True, log=lambda *a: None)
    assert res["correct"], res["checks"]
    limits = {k: v["limit"] for k, v in res["checks"].items()}
    assert not harness.check.verdict(res["control"], limits), res["control"]
