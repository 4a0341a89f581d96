"""Whole runs of a tiny cell on the CPU, past the harness's look for a
card: a sound run is correct; the control (the reference in bfloat16 in
the program's place) and faults planted under the timed path are not;
the measured process loads no JAX; without a card the command prints no
result."""

import json
import shutil
import subprocess
import sys
import time

import numpy as np
import pytest

from tiny_cell import REPO, TINY
from motifbench import harness


@pytest.fixture
def cpu():
    from lightmotif_tpu_torch.ops.pipeline import use_device

    use_device("cpu")
    yield
    use_device(None)


def tiny_run(root, seed=11, **kw):
    return harness.run(root, TINY, seed, 0.3, False, t_start=time.perf_counter(),
                       device="cpu", bench=root, log=lambda *a: None, **kw)


def test_sound_run_is_correct_and_reports_its_metrics(tiny_root, cpu):
    res = tiny_run(tiny_root, seed=2**31 + 17)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert {"pssm_bp_rate", "peak_mem_gib", "setup_s"} <= set(res["metrics"])
    assert list(res)[-1] == "checks"
    for name, got in res["checks"].items():
        assert got["value"] <= got["limit"], name


def test_traced_run_reads_per_layer_metrics(tiny_root, cpu):
    res = harness.run(tiny_root, TINY, 12, 0.3, True, t_start=time.perf_counter(),
                      device="cpu", bench=tiny_root, log=lambda *a: None)
    assert res["correct"]
    assert {"matrix.thresholds_s", "scanner.first_scan_s", "scanner.reruns_per_scan"} <= set(
        res["metrics"])
    assert "prefilter.roofline_pct" not in res["metrics"]  # no device operation on the CPU
    assert res["device"]["window_s"] > 0 and "breakdown" in res


def test_control_fails(tiny_root, cpu):
    res = tiny_run(tiny_root, seed=5, control=True)
    assert res["correct"]
    limits = {k: v["limit"] for k, v in res["checks"].items()}
    assert not harness.check.verdict(res["control"], limits)


def stale(real):
    """Each scan returns the previous scan's hits."""
    prev = []

    def scan_arrays(self, seq):
        out = real(self, seq)
        prev.append(out)
        return prev[-2] if len(prev) > 1 else out
    return scan_arrays


def half_left_out(real):
    """The hits of half of the motifs (the reverse strands) go missing."""
    def scan_arrays(self, seq):
        ids, pos, sc = real(self, seq)
        keep = ids < len(self.pssms) // 2
        return ids[keep], pos[keep], sc[keep]
    return scan_arrays


def score_altered(real):
    def scan_arrays(self, seq):
        ids, pos, sc = real(self, seq)
        sc = sc.copy()
        sc[len(sc) // 2] += np.float32(0.01)
        return ids, pos, sc
    return scan_arrays


def hit_dropped(real):
    def scan_arrays(self, seq):
        ids, pos, sc = real(self, seq)
        drop = np.arange(len(ids)) != len(ids) // 3
        return ids[drop], pos[drop], sc[drop]
    return scan_arrays


@pytest.mark.parametrize("fault", [stale, half_left_out, score_altered, hit_dropped])
def test_faults_under_the_timed_path_are_not_correct(tiny_root, cpu, monkeypatch, fault):
    from lightmotif_tpu_torch.scanner import MultiScanner

    real = MultiScanner.scan_arrays
    broken = fault(real)
    calls = []

    def scan_arrays(self, seq):  # set-up's one scan of each sequence stays sound
        calls.append(seq)
        return broken(self, seq) if len(calls) > 6 else real(self, seq)

    monkeypatch.setattr(MultiScanner, "scan_arrays", scan_arrays)
    res = tiny_run(tiny_root, seed=21)
    assert len(calls) > 6
    assert not res["correct"], res["checks"]


def test_measured_process_loads_no_jax(tiny_root):
    code = (
        "import sys, time\n"
        f"sys.path[:0] = [{str(REPO)!r}]\n"
        "from lightmotif_tpu_torch.ops.pipeline import use_device\n"
        "use_device('cpu')\n"
        "from motifbench import harness\n"
        f"harness.run(__import__('pathlib').Path({str(tiny_root)!r}), {TINY!r}, 3, 0.2, False,"
        f" t_start=time.perf_counter(), device='cpu', bench=__import__('pathlib').Path("
        f"{str(tiny_root)!r}), log=lambda *a: None)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=tiny_root)
    assert out.returncode == 0, out.stderr[-2000:]
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "lightmotif_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "lightmotif_tpu"}


@pytest.fixture
def no_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")


def test_no_card_no_result(no_card):
    out = subprocess.run([sys.executable, str(REPO / "motifbench/run.py"), "--workload",
                          "ecoli.genomes-p1e-5", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=600,
                         cwd=REPO)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_no_result(tmp_path):
    shutil.copytree(REPO / "motifbench", tmp_path / "motifbench",
                    ignore=shutil.ignore_patterns("build-cache", "__pycache__"))
    (tmp_path / "BENCHMARK.json").write_text((REPO / "BENCHMARK.json").read_text())
    out = subprocess.run([sys.executable, "motifbench/run.py", "--workload",
                          "ecoli.genomes-p1e-5", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, timeout=600,
                         cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
