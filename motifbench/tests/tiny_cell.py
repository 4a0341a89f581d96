"""A tiny cell of the same shape as the real ones (a database of every
length from 5 to 35 on both strands, sequences with wildcard runs), for
runs on the CPU through the program's plain versions."""

import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY = "tiny.seqs"


def make_tiny_root(tmp_path: Path) -> Path:
    """A checkout-like root holding a one-cell ``BENCHMARK.json`` and its
    configuration, traffic and limits: 38 profiles over 6 sequences of
    30,000 bp with wildcard runs, p < 1e-3."""
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    conf = json.loads((REPO / "motifbench/configs/jaspar2024-ecoli.json").read_text())
    conf["name"] = "tiny"
    lengths = {str(m): 1 for m in range(5, 36)}
    lengths.update({"5": 3, "8": 3, "12": 3, "20": 2})
    conf["database"]["lengths"] = lengths
    conf["database"]["profiles"] = sum(lengths.values())
    conf["sequence"] = {"length": 30000, "n_runs": [[0, 100], [14000, 700], [-50, 50]]}
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "limits").mkdir()
    (tmp_path / "configs/tiny.json").write_text(json.dumps(conf))
    (tmp_path / "traffic/seqs.json").write_text(json.dumps(
        {"name": "seqs", "pvalue": 1e-3, "loop": "closed", "clients": 1, "sequences": 6,
         "order": "in turn", "check_scans": 3, "check_draw": 3, "trace_scans": 2}))
    limits = json.loads((REPO / "motifbench/limits/ecoli.genomes-p1e-5.json").read_text())
    (tmp_path / f"limits/{TINY}.json").write_text(json.dumps(limits))
    spec = dict(real)
    spec["configs"] = [{"name": "tiny", "source": "a test", "file": "configs/tiny.json",
                        "reduced": [], "why": "a test"}]
    spec["workloads"] = [{"name": TINY, "config": "tiny", "traffic": "seqs", "chips": 1,
                          "why": "a test"}]
    spec["end_to_end"] = [dict(m, workloads=[TINY]) for m in real["end_to_end"]]
    spec["per_layer"] = [dict(m, workloads=[TINY]) for m in real["per_layer"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path
