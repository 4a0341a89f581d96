"""Tiny cells for runs on the CPU through the program's plain versions:
one of the same shape as the real ones (a database of every length from
5 to 35 on both strands, sequences with wildcard runs), one that scans
DNA record sets, and one that scans a protein database over record
sets."""

import json
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
TINY = "tiny.seqs"
RECORDS = "tiny.records"
PROTEIN = "tiny.proteome"

#: Amino-acid frequencies over ``ACDEFGHIKLMNPQRSTVWY``, 0 for ``X``;
#: their float32 sum is 1, as the program's ``Background`` asks.
PROTEIN_BG = [0.08, 0.02, 0.05, 0.06, 0.04, 0.07, 0.02, 0.06, 0.06, 0.1, 0.02, 0.04,
              0.05, 0.04, 0.05, 0.07, 0.05, 0.07, 0.01, 0.04, 0.0]


def make_tiny_root(tmp_path: Path) -> Path:
    """A checkout-like root holding a one-cell ``BENCHMARK.json`` and its
    configuration, traffic and limits: 38 profiles over 6 sequences of
    30,000 bp with wildcard runs, p < 1e-3."""
    conf = json.loads((REPO / "motifbench/configs/jaspar2024-ecoli.json").read_text())
    conf["name"] = "tiny"
    lengths = {str(m): 1 for m in range(5, 36)}
    lengths.update({"5": 3, "8": 3, "12": 3, "20": 2})
    conf["database"]["lengths"] = lengths
    conf["database"]["profiles"] = sum(lengths.values())
    conf["sequence"] = {"length": 30000, "n_runs": [[0, 100], [14000, 700], [-50, 50]]}
    return write_root(tmp_path, TINY, conf, {"name": "seqs", "sequences": 6})


def make_records_root(tmp_path: Path, strands: int = 2) -> Path:
    """The tiny cell's database (on ``strands`` strands) over 4 record
    sets of 92 DNA records of 3 to 2,000 bp, some shorter than the
    longest motif, p < 1e-3."""
    conf = json.loads((make_tiny_root(tmp_path / "seqs") / "configs/tiny.json").read_text())
    conf["database"]["strands"] = strands
    conf["sequence"] = {"records": {"3": 3, "20": 5, "34": 4, "150": 50, "600": 20,
                                    "2000": 10}}
    return write_root(tmp_path, RECORDS, conf, {"name": "sets", "sequences": 4})


def make_protein_root(tmp_path: Path) -> Path:
    """A protein database of 42 profiles of 5 to 40 residues (those past
    32 take the program's dense path) on one strand against a non-uniform
    background, over 4 record sets of 79 proteins of 3 to 1,500 residues
    drawn from that background, p < 1e-3."""
    conf = json.loads((REPO / "motifbench/configs/jaspar2024-ecoli.json").read_text())
    del conf["complement"]
    conf.update(name="tiny", alphabet="ACDEFGHIKLMNPQRSTVWYX")
    lengths = {str(m): 1 for m in range(5, 41)}
    lengths.update({"6": 3, "9": 3, "15": 2, "36": 2})
    conf["database"].update(strands=1, background=PROTEIN_BG, lengths=lengths,
                            profiles=sum(lengths.values()))
    conf["sequence"] = {"records": {"3": 2, "30": 3, "120": 40, "400": 30, "1500": 4},
                        "composition": "background"}
    return write_root(tmp_path, PROTEIN, conf, {"name": "proteomes", "sequences": 4})


def write_root(tmp_path: Path, workload: str, conf: dict, traffic: dict) -> Path:
    """A checkout-like root holding a one-cell ``BENCHMARK.json`` (the
    real metrics, each for this cell) and the cell's configuration
    ``conf``, traffic (``traffic`` over a closed loop of one client at p <
    1e-3, 3 scans checked and 2 traced) and the real cells' limits."""
    real = json.loads((REPO / "BENCHMARK.json").read_text())
    tmp_path.mkdir(parents=True, exist_ok=True)
    (tmp_path / "configs").mkdir()
    (tmp_path / "traffic").mkdir()
    (tmp_path / "limits").mkdir()
    (tmp_path / "configs/tiny.json").write_text(json.dumps(conf))
    traffic = {"pvalue": 1e-3, "loop": "closed", "clients": 1, "order": "in turn",
               "check_scans": 3, "check_draw": 3, "trace_scans": 2, **traffic}
    (tmp_path / f"traffic/{traffic['name']}.json").write_text(json.dumps(traffic))
    limits = json.loads((REPO / "motifbench/limits/ecoli.genomes-p1e-5.json").read_text())
    (tmp_path / f"limits/{workload}.json").write_text(json.dumps(limits))
    spec = dict(real)
    spec["configs"] = [{"name": "tiny", "source": "a test", "file": "configs/tiny.json",
                        "reduced": [], "why": "a test"}]
    spec["workloads"] = [{"name": workload, "config": "tiny", "traffic": traffic["name"],
                          "chips": 1, "why": "a test"}]
    spec["end_to_end"] = [dict(m, workloads=[workload]) for m in real["end_to_end"]]
    spec["per_layer"] = [dict(m, workloads=[workload]) for m in real["per_layer"]]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path
