"""Profiling and throughput observability.

Counterpart of :mod:`lightmotif_tpu.utils.profiling`.  The reference has
no tracing beyond ``cargo bench`` MB/s counters
(``lightmotif-bench/dna.rs:48-49``); here the equivalents are:

* :func:`profile_trace` -- context manager around ``torch.profiler``
  that writes a Chrome trace (open it in Perfetto or
  ``chrome://tracing``) into a directory;
* :func:`throughput` -- positions/s of a callable, with the CUDA devices
  synchronised around every repetition;
* :class:`ScanStats` -- counters a scanning loop can update to report
  positions and bytes processed per second (the MB/s metric the
  reference benches print);
* :func:`span` -- a named stage of the program (``upload.pad``,
  ``scanner.dispatch``, ``fetch.wait``, ...) with counts attached at its
  close, recorded only while a ``torch.profiler`` session is on: as a
  ``record_function`` range on the profiler's timeline, beside the
  device's kernels and copies, and in memory (:func:`spans`), grouped
  by scan.  With no profiler on, a span is one check;
* :func:`before_scan` and :func:`after_scan` -- work done for a scan
  outside its outermost span (a record set's join and upload before it,
  the mapping of its hits to records after it): the spans opened inside
  with no span open join that scan, top-level beside its outermost span.
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import os
import threading
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["profile_trace", "throughput", "ScanStats", "SpanRecord", "span", "root_span",
           "before_scan", "after_scan", "spans", "reset_spans"]


@contextlib.contextmanager
def profile_trace(logdir: str):
    """Profile the enclosed block (the CPU, and the CUDA devices when
    there are any) and write its Chrome trace to ``logdir/trace.json``.
    The profiler is yielded, for ``key_averages()``."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def throughput(fn, *args, positions: int, reps: int = 5) -> dict:
    """Best wall-clock positions/s of ``fn(*args)`` over ``reps`` calls
    after a warm-up call, the CUDA devices synchronised before and after
    each."""
    fn(*args)  # warm-up: builds, caches, uploads
    best = float("inf")
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        fn(*args)
        _sync()
        best = min(best, time.perf_counter() - t0)
    return {
        "seconds": best,
        "positions": positions,
        "positions_per_second": positions / best,
        "mb_per_second": positions / best / 1e6,  # 1 byte/position
    }


@dataclass
class ScanStats:
    """Counters for a scanning loop (positions == bytes for DNA)."""

    positions: int = 0
    hits: int = 0
    sequences: int = 0
    started: float = field(default_factory=time.perf_counter)

    def update(self, positions: int = 0, hits: int = 0, sequences: int = 0):
        self.positions += positions
        self.hits += hits
        self.sequences += sequences

    @property
    def elapsed(self) -> float:
        return time.perf_counter() - self.started

    @property
    def positions_per_second(self) -> float:
        return self.positions / self.elapsed if self.elapsed else 0.0

    def summary(self) -> str:
        return (
            f"{self.sequences} sequences, {self.positions} positions, "
            f"{self.hits} hits in {self.elapsed:.2f}s "
            f"({self.positions_per_second / 1e6:.1f} Mpos/s)"
        )


#: Scans whose spans :func:`spans` keeps, the newest.
SCANS_KEPT = 64


class SpanRecord(NamedTuple):
    """One closed span: its name, its start and end (``time.time_ns()``),
    its id and its parent's (``None`` for the outermost), the id of its
    scan (the outermost span's id, shared by every span inside it) and
    the counts attached to it."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    scan: int
    counts: dict


class _Off:
    """The span of a stage that no profiler records: does nothing, and
    is false, so that a caller computes its counts only when on."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __bool__(self):
        return False

    def add(self, **counts) -> None:
        pass


_OFF = _Off()
_IDS = itertools.count(1)
_SCANS = collections.deque(maxlen=SCANS_KEPT)  # one list of SpanRecords per scan
#: Per thread: ``open``, its open spans, the outermost first; ``join``,
#: ``"next"`` or ``"last"`` inside :func:`before_scan` / :func:`after_scan`;
#: ``held``, the records of spans waiting for the next scan; ``last``, the
#: id and records of the scan opened last.
_LOCAL = threading.local()


def _open() -> list:
    stack = getattr(_LOCAL, "open", None)
    if stack is None:
        stack = _LOCAL.open = []
    return stack


def _held() -> collections.deque:
    held = getattr(_LOCAL, "held", None)
    if held is None:
        held = _LOCAL.held = collections.deque(maxlen=SCANS_KEPT)
    return held


def _top_level(span_id: int) -> tuple:
    """``(scan, records)`` of a span opened with no span open on this
    thread: the scan opened last inside :func:`after_scan`; inside
    :func:`before_scan` a list held for the next scan; else a scan of its
    own, which takes the held spans."""
    join = getattr(_LOCAL, "join", None)
    if join == "last" and getattr(_LOCAL, "last", None) is not None:
        return _LOCAL.last
    records = []
    if join == "next":
        _held().append(records)
        return span_id, records
    _SCANS.append(records)
    held = _held()
    while held:
        records.extend(r._replace(scan=span_id) for r in held.popleft())
    _LOCAL.last = (span_id, records)
    return span_id, records


class _Span:
    __slots__ = ("name", "counts", "id", "parent", "scan", "records", "start", "range")

    def __init__(self, name: str, counts: dict):
        self.name, self.counts = name, counts

    def add(self, **counts) -> None:
        """Attach counts (host values) to the span."""
        self.counts.update(counts)

    def __enter__(self):
        stack = _open()
        self.id = next(_IDS)
        if stack:
            top = stack[-1]
            self.parent, self.scan, self.records = top.id, top.scan, top.records
        else:
            self.parent = None
            self.scan, self.records = _top_level(self.id)
        stack.append(self)
        # the ops of torch.profiler.record_function, called here: under the
        # profiler's stack tracer its Python wrapper puts tens of
        # microseconds between the clock and the range's own ends
        self.start = time.time_ns()
        self.range = torch.ops.profiler._record_function_enter_new(self.name, None)
        return self

    def __exit__(self, *exc):
        with torch._C.DisableTorchFunctionSubclass():
            torch.ops.profiler._record_function_exit._RecordFunction(self.range)
        end = time.time_ns()
        _open().pop()
        self.records.append(SpanRecord(self.name, self.start, end, self.id, self.parent,
                                       self.scan, self.counts))
        return False


def span(name: str, **counts):
    """A context manager around a stage of the program named ``name``
    (layer first: ``upload.pad``, ``fetch.wait``), ``counts`` its first
    counts; the object it yields takes more at any time before its close
    (``add(**counts)``) and is true only when the span records.

    A span records only while a ``torch.profiler`` session is on: it
    opens a ``torch.profiler.record_function`` range named ``name`` (so
    an exported Chrome trace holds the stage on the clock of the
    device's kernels)
    and, at its close, appends a :class:`SpanRecord` to its scan, the
    spans inside the outermost one open on this thread (:func:`spans`;
    :func:`before_scan` and :func:`after_scan` for work outside it).
    Otherwise it is one check and a shared object that does nothing: no
    allocation on a device, no synchronisation, no read.  Counts come
    from values the host holds; a span never reads the device."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, counts)


def root_span(name: str):
    """:func:`span` where no span is open on this thread, else the span
    that does nothing: for public calls that nest (``scan_arrays``
    calling ``collect_arrays``), so that the outermost one opens the
    scan."""
    if not _autograd_profiler._is_profiler_enabled or _open():
        return _OFF
    return _Span(name, {})


class _Joining:
    """The context of :func:`before_scan` and :func:`after_scan`."""

    __slots__ = ("join", "saved")

    def __init__(self, join: str):
        self.join = join

    def __enter__(self):
        self.saved = getattr(_LOCAL, "join", None)
        _LOCAL.join = self.join
        return self

    def __exit__(self, *exc):
        _LOCAL.join = self.saved
        return False


def before_scan():
    """A context for work that prepares a scan before its outermost span
    opens (a record set's join and upload): the spans opened inside with
    no span open on this thread join the next scan opened on it, as
    top-level spans (``parent`` ``None``) beside its outermost one.  With
    no profiler on, one check and the shared object that does nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Joining("next")


def after_scan():
    """A context for work on a scan's results after its outermost span
    has closed (a record set's hits mapped to records): the spans opened
    inside with no span open on this thread join the scan opened last on
    it, as top-level spans, or open a scan of their own where there is
    none.  With no profiler on, one check and the shared object that does
    nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Joining("last")


def spans() -> list:
    """The :class:`SpanRecord` s of the newest :data:`SCANS_KEPT` scans, a
    scan's spans together, the scans and the spans of each in the order
    they opened."""
    return [r for records in list(_SCANS) for r in sorted(records, key=lambda r: r.id)]


def reset_spans() -> None:
    """Forget every recorded span, and this thread's spans held for the
    next scan and its last scan."""
    _SCANS.clear()
    _held().clear()
    _LOCAL.last = None
