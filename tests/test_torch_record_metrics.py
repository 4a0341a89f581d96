"""The benchmark's per-layer metrics of a protein record set, on
synthetic spans and traces: the host's join and mapping of the records,
the dense path's device time and K1's roofline share there, and the
share of the warpgroup prefilter's operations on deep shapes."""

import importlib.util
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def bench(monkeypatch):
    """``motifbench``'s span mapping and trace modules."""
    monkeypatch.syspath_prepend(str(ROOT))
    from motifbench import spans, trace

    return SimpleNamespace(spans=spans, trace=trace)


def reader(name):
    path = ROOT / "motifbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"motifbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def span(name, scan, id_, parent=None, ms=0.0, **counts):
    return SimpleNamespace(name=name, id=id_, parent=parent, scan=scan, start_ns=0,
                           end_ns=int(ms * 1e6), counts=counts)


def traced(records, n_scans=2):
    """A run whose trace holds ``n_scans`` scans and whose program kept
    ``records``."""
    return SimpleNamespace(trace=SimpleNamespace(scan_bp=[[100]] * n_scans)), records


def test_records_host_ms_reads_the_join_and_the_mapping(bench, monkeypatch):
    records = []
    for scan, (join, mapped) in zip((1, 20), ((1.0, 2.0), (1.5, 3.5))):
        records += [span("records.join", scan, scan - 1 if scan > 1 else 0, ms=join),
                    span("upload.pad", scan, scan + 1, ms=9.0),
                    span("scanner.scan", scan, scan, ms=50.0),
                    span("records.map", scan, scan + 5, ms=mapped)]
    run, records = traced(records)
    monkeypatch.setattr(bench.spans, "records", lambda: records)
    assert reader("records.host_ms_per_scan")(run) == pytest.approx((3.0 + 5.0) / 2)
    dna = [r for r in records if not r.name.startswith("records.")]
    monkeypatch.setattr(bench.spans, "records", lambda: dna)
    assert reader("records.host_ms_per_scan")(run) is None  # no record set


@pytest.mark.parametrize("counts,share", [
    ([{"issued_ops": 4, "deep_ops": 3}, {"issued_ops": 4, "deep_ops": 0}], 3 / 8),
    ([{"issued_ops": 5, "deep_ops": 5}] * 2, 1.0),
    ([{"issued_ops": 0, "deep_ops": 0}] * 2, None),
    ([{"gmma": 1, "issued_ops": 5}] * 2, None),
], ids=["mixed", "all-deep", "no-warpgroup-launch", "a-program-without-the-count"])
def test_deep_share_reads_the_prefilter_spans(bench, monkeypatch, counts, share):
    records = []
    for scan in (1, 10):
        records.append(span("scanner.scan", scan, scan))
        records += [span("prefilter", scan, scan + 1 + i, scan, **c) for i, c in enumerate(counts)]
    run, records = traced(records)
    monkeypatch.setattr(bench.spans, "records", lambda: records)
    got = reader("prefilter.deep_share")(run)
    assert got == (None if share is None else pytest.approx(share))


DENSE_CORE = "lightmotif_tpu_torch/ops/multi.py(681): dense_core"


def dense_slice(bench, scan_bp):
    """A traced slice (us): K1 (20 us) and a mask op (5 us) launched inside
    ``dense_core``, and the prefilter (100 us) outside it."""
    events = [{"ph": "X", "cat": "user_annotation", "name": bench.trace.RANGE, "ts": 0.0,
               "dur": 10_000.0, "tid": 1},
              {"ph": "X", "cat": "python_function", "name": DENSE_CORE, "ts": 100.0,
               "dur": 200.0, "tid": 1}]
    kernels = [("void score_kernel<false, 8, 16>(unsigned char const*)", 150.0, 20.0),
               ("void at::native::vectorized_elementwise_kernel<4>(int)", 160.0, 5.0),
               ("void gmma_prefilter<2>(unsigned char const*)", 400.0, 100.0)]
    for i, (name, launch, dur) in enumerate(kernels):
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                       "ts": launch, "dur": 2.0, "tid": 1, "args": {"correlation": i}})
        events.append({"ph": "X", "cat": "kernel", "name": name, "ts": 1000.0 + 200 * i,
                       "dur": dur, "args": {"correlation": i, "device": 0}})
    return bench.trace.Slice(events, scan_bp)


def test_dense_metrics_read_what_dense_core_launches(bench):
    from lightmotif_tpu_torch.scanner import MultiScanner

    assert MultiScanner.dense_m_limit(21) == 32
    scan_bp = [[100, 50, 20]]
    run = SimpleNamespace(trace=dense_slice(bench, scan_bp), lengths=np.array([10, 40, 33]),
                          k=21)
    assert reader("dense.ms_per_scan")(run) == pytest.approx(0.025)
    # motifs of 40 and 33 residues: window starts in each record, none past it
    bound = 0.0
    for m in (40, 33):
        starts = sum(max(n - m + 1, 0) for n in scan_bp[0])
        bound += max((170 + 4 * starts) / 3.35e12, m * starts / 67e12)
    assert reader("dense.roofline_pct")(run) == pytest.approx(100 * bound / 20e-6)


def test_dense_metrics_give_none_without_the_dense_path(bench):
    assert reader("dense.ms_per_scan")(SimpleNamespace(trace=None)) is None
    assert reader("dense.roofline_pct")(SimpleNamespace(trace=None)) is None
    t = dense_slice(bench, [[100]])
    t.ops = [o for o in t.ops if o["name"].startswith("gmma")]
    run = SimpleNamespace(trace=t, lengths=np.array([10]), k=21)
    assert reader("dense.ms_per_scan")(run) is None
    assert reader("dense.roofline_pct")(run) is None
