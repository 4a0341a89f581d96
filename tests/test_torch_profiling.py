"""The port's profiling utilities (``lightmotif_tpu_torch.utils``) on the
CPU: a Chrome trace of a scan, a throughput measurement and the scan
counters, beside the JAX package's ``ScanStats``."""

import json

import numpy as np

import lightmotif_tpu_torch as tlm
from lightmotif_tpu.utils import ScanStats as JaxScanStats
from lightmotif_tpu_torch.utils import ScanStats, profile_trace, throughput

from .data import PATTERNS


def pssm_and_genome():
    cm = tlm.CountMatrix.from_sequences(tlm.EncodedSequence.encode(p) for p in PATTERNS)
    genome = np.random.default_rng(1).integers(0, 4, 20_000).astype(np.uint8)
    return cm.to_freq(0.1).to_weight(None).to_scoring(), tlm.EncodedSequence(genome)


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    pssm, seq = pssm_and_genome()
    with profile_trace(str(tmp_path / "trace")) as prof:
        hits = tlm.Scanner(pssm, seq, threshold=-5.0, device="cpu").collect()
    assert hits
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name", "") for e in trace["traceEvents"]}
    assert any("aten::" in n for n in names)
    assert prof.key_averages()


def test_throughput():
    pssm, seq = pssm_and_genome()
    calls = []

    def scan():
        calls.append(1)
        return tlm.Scanner(pssm, seq, threshold=-5.0, device="cpu").collect()

    out = throughput(scan, positions=len(seq), reps=3)
    assert len(calls) == 4  # a warm-up and three timed calls
    assert set(out) == {"seconds", "positions", "positions_per_second", "mb_per_second"}
    assert out["positions"] == len(seq) and out["seconds"] > 0
    assert out["positions_per_second"] == len(seq) / out["seconds"]
    assert out["mb_per_second"] == out["positions_per_second"] / 1e6


def test_scan_stats_counts_like_the_jax_package():
    mine, theirs = ScanStats(), JaxScanStats()
    for stats in (mine, theirs):
        stats.update(positions=1000, hits=3, sequences=1)
        stats.update(positions=500, sequences=1)
    for field in ("positions", "hits", "sequences"):
        assert getattr(mine, field) == getattr(theirs, field)
    assert mine.elapsed > 0 and mine.positions_per_second > 0
    assert mine.summary().startswith("2 sequences, 1500 positions, 3 hits in ")
