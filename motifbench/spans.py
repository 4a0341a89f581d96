"""The program's own spans of the traced scans, for the per-layer
metrics that read them.

The program records a span at each stage of a scan while a
``torch.profiler`` session is on (``lightmotif_tpu_torch.utils.
profiling.spans()``: name, start and end by ``time.time_ns()``, parent,
scan, counts), the root ``scanner.scan`` opened by ``scan_arrays``.  A
traced run profiles one warm scan and then the slice's scans, so the
newest ``len(trace.scan_bp)`` scans are the slice's.  A program without
spans gives none, and a metric that reads them gives ``None``.

To lay spans on the trace's clock, each root is paired with the
outermost ``scan_arrays`` or ``collect_arrays`` call of the scanner that
the trace holds as a Python event of the main thread (``scan_arrays``
of a sequence, which calls ``collect_arrays``; ``collect_arrays`` of a
record set's batch scanner), and the offset is the median difference of
their midpoints: the call encloses its root with some Python at either
end, which the profiler's stack tracer slows (their starts differ by
tens of microseconds on a slow host, their midpoints by a few).  A
record set's upload runs before its root opens, so its spans are no
scan's, and the metrics that read them give ``None`` there.
"""

from __future__ import annotations

import re
import statistics

ROOT = "scanner.scan"
#: The Python events of the calls that open a scan's root span.
CALL = re.compile(r"scanner\.py\(\d+\): (scan_arrays|collect_arrays)$")


def records() -> list:
    """The program's span records, or ``[]`` where it keeps none."""
    from lightmotif_tpu_torch.utils import profiling

    read = getattr(profiling, "spans", None)
    return list(read()) if read else []


def traced_scans(run, recs=None) -> list:
    """The span records of each traced scan, oldest first (``recs``:
    the program's by default); ``[]`` without a trace or spans."""
    if run.trace is None:
        return []
    by_scan = {}
    for r in records() if recs is None else recs:
        by_scan.setdefault(r.scan, []).append(r)
    scans = [rs for _, rs in sorted(by_scan.items())
             if any(r.parent is None and r.name == ROOT for r in rs)]
    return scans[-len(run.trace.scan_bp):]


def _ms(r) -> float:
    return (r.end_ns - r.start_ns) / 1e6


def median_ms(scans: list, names) -> float | None:
    """The median over ``scans`` of each scan's ms in the spans named in
    ``names``; ``None`` where no scan has one."""
    if not any(r.name in names for rs in scans for r in rs):
        return None
    return statistics.median(sum(_ms(r) for r in rs if r.name in names) for rs in scans)


def self_ms(scans: list, name: str, minus: str) -> float | None:
    """The median over ``scans`` of each scan's ms in the spans ``name``
    less the spans ``minus`` inside them; ``None`` where no scan has
    ``name``."""
    def one(rs):
        by_id = {r.id: r for r in rs}

        def under(r):
            while r.parent is not None:
                r = by_id[r.parent]
                if r.name == name:
                    return True
            return False

        return (sum(_ms(r) for r in rs if r.name == name)
                - sum(_ms(r) for r in rs if r.name == minus and under(r)))

    if not any(r.name == name for rs in scans for r in rs):
        return None
    return statistics.median(one(rs) for rs in scans)


def count_total(scans: list, name: str, key: str) -> int | None:
    """The sum over ``scans`` of the count ``key`` of the spans
    ``name``; ``None`` where none has it."""
    counts = [r.counts[key] for rs in scans for r in rs if r.name == name and key in r.counts]
    return sum(counts) if counts else None


def offset_ns(trace, scans: list) -> int | None:
    """What to add to a span's ``time_ns`` to get the trace's clock, in
    ns: the median difference of the midpoints of each root and its
    outermost :data:`CALL` in the trace's slice, the newest paired with
    the newest; ``None`` where either is missing."""
    calls = []
    for ts, end in sorted((ts, end) for ts, end, name in trace._host
                          if CALL.search(name) and trace._lo <= ts <= trace._hi):
        if not calls or ts >= calls[-1][1]:
            calls.append((ts, end))
    roots = sorted((r.start_ns, r.end_ns) for rs in scans for r in rs
                   if r.parent is None and r.name == ROOT)
    n = min(len(calls), len(roots))
    if not n:
        return None
    return statistics.median(round((c0 + c1) * 500) - (r0 + r1) // 2
                             for (c0, c1), (r0, r1) in zip(calls[-n:], roots[-n:]))


def merged(spans) -> list:
    out = []
    for t0, t1 in sorted(spans):
        if out and t0 <= out[-1][1]:
            out[-1][1] = max(out[-1][1], t1)
        else:
            out.append([t0, t1])
    return out


def intersect(a: list, b: list) -> list:
    """The intersection of two merged interval lists, merged."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if lo < hi:
            out.append([lo, hi])
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(spans: list) -> float:
    return sum(t1 - t0 for t0, t1 in spans)


def idle(trace) -> list:
    """The slice's idle intervals of the device (trace clock, us)."""
    gaps, end = [], trace._lo
    for t0, t1 in sorted((o["ts"], o["ts"] + o["dur"]) for o in trace.ops):
        if t0 > end:
            gaps.append([end, t0])
        end = max(end, t1)
    if trace._hi > end:
        gaps.append([end, trace._hi])
    return gaps


def host_idle_ms(trace, scans: list) -> float | None:
    """The device's idle ms per traced scan that falls inside the scans'
    spans but outside their ``fetch.wait`` spans: the device waiting on
    the program's own host work.  ``None`` without device operations or
    spans to lay on the trace."""
    if trace is None or not trace.ops or not scans:
        return None
    off = offset_ns(trace, scans)
    if off is None:
        return None

    def on_trace(name=None):
        return merged(((r.start_ns + off) / 1e3, (r.end_ns + off) / 1e3)
                      for rs in scans for r in rs
                      if (r.parent is None if name is None else r.name == name))

    busy_host = intersect(merged(idle(trace)), on_trace())
    waiting = intersect(busy_host, on_trace("fetch.wait"))
    return (length(busy_host) - length(waiting)) / 1e3 / len(trace.scan_bp)
