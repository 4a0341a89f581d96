"""The per-layer metrics that read the program's spans: a traced run of
the tiny cell on the CPU, a program without spans, and the device's idle
time put down to the program's host work on a hand-made trace."""

import time
from types import SimpleNamespace

import pytest

from tiny_cell import TINY
from motifbench import harness, spans, trace

#: The metrics that read the program's spans, and whether each needs the
#: device's operations in the trace.
METRICS = {"upload.host_ms_per_scan": False, "scanner.issue_ms_per_scan": False,
           "fetch.wait_ms_per_scan": False, "fetch.host_ms_per_scan": False,
           "exact.candidates_per_scan": False, "exact.kept_per_candidate": False,
           "fetch.reads_per_scan": False, "device.host_idle_ms_per_scan": True}


@pytest.fixture
def cpu():
    from lightmotif_tpu_torch.ops.pipeline import use_device

    use_device("cpu")
    yield
    use_device(None)


def test_traced_tiny_run_reads_the_program_spans(tiny_root, cpu):
    res = harness.run(tiny_root, TINY, 2**31 + 23, 0.3, True, t_start=time.perf_counter(),
                      device="cpu", bench=tiny_root, log=lambda *a: None)
    assert res["correct"]
    got = res["metrics"]
    for name, needs_device in METRICS.items():
        assert (name in got) != needs_device, name  # no device operation on the CPU
    assert got["fetch.reads_per_scan"]["value"] == 1
    assert got["exact.candidates_per_scan"]["value"] > 0
    assert got["exact.kept_per_candidate"]["value"] > 0
    assert got["scanner.issue_ms_per_scan"]["value"] > 0


def test_a_program_without_spans_gives_none(monkeypatch):
    from lightmotif_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "spans")
    run = SimpleNamespace(trace=SimpleNamespace(scan_bp=[1, 2], ops=[{}], _host=[],
                                                _lo=0.0, _hi=1.0))
    for name in METRICS:
        assert harness.reader(name)(run) is None, name


def record(name, start_us, end_us, id_, parent, scan=1):
    # the program's clock is the trace's plus 5 ms here
    return SimpleNamespace(name=name, start_ns=int((start_us + 5000) * 1000),
                           end_ns=int((end_us + 5000) * 1000), id=id_, parent=parent, scan=scan,
                           counts={})


def planted(gap_in: str):
    """A slice of one scan (trace clock, us): the root 0-1000 inside its
    ``scan_arrays`` call, ``upload.pad`` 0-100, ``scanner.dispatch``
    100-500 and ``fetch`` 500-1000 with ``fetch.wait`` 500-900; the device
    busy throughout but a 40 us gap inside ``gap_in``."""
    where = {"upload.pad": 40.0, "fetch.wait": 700.0}[gap_in]
    events = [
        {"ph": "X", "cat": "user_annotation", "name": trace.RANGE, "ts": -10, "dur": 1020,
         "tid": 1},
        {"ph": "X", "cat": "python_function", "name": "lightmotif_tpu_torch/scanner.py(680): "
         "scan_arrays", "ts": -4, "dur": 1008, "tid": 1},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": -10, "dur": where + 10,
         "args": {"device": 0}},
        {"ph": "X", "cat": "kernel", "name": "k", "ts": where + 40, "dur": 1010 - where - 40,
         "args": {"device": 0}},
    ]
    scan = [record("scanner.scan", 0, 1000, 1, None), record("upload.pad", 0, 100, 2, 1),
            record("scanner.dispatch", 100, 500, 3, 1), record("fetch", 500, 1000, 4, 1),
            record("fetch.wait", 500, 900, 5, 4)]
    return trace.Slice(events, [1000]), [scan]


@pytest.mark.parametrize("gap_in, want_ms", [("upload.pad", 0.04), ("fetch.wait", 0.0)])
def test_host_idle_counts_gaps_in_host_work_and_not_in_the_wait(gap_in, want_ms):
    slice_, scans = planted(gap_in)
    assert spans.offset_ns(slice_, scans) == -5_000_000
    assert spans.host_idle_ms(slice_, scans) == pytest.approx(want_ms)
    assert spans.self_ms(scans, "fetch", "fetch.wait") == pytest.approx(0.1)
    assert spans.median_ms(scans, ("upload.pad",)) == pytest.approx(0.1)
