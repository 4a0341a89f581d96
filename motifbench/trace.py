"""The arithmetic of a profiled slice of the window (``torch.profiler``
with CUDA activity and Python stacks), copied in spirit from
``chip_smoke.py::trace_kernels``: the device's work inside the slice's
range, the union of its intervals (work on two streams at once counts
once), and for each device operation the Python functions that were on
the stack when the host launched it.

A per-layer metric (``metrics/<name>.py``) picks its operations by
kernel name and by launching function, both its own data.
"""

from __future__ import annotations

import json
import os
import re
import tempfile

#: The ``record_function`` range that bounds the slice.
RANGE = "motifbench.slice"

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("python_function", "cpu_op", "cuda_runtime", "cuda_driver")


def events_of(prof) -> list:
    """The chrome-trace events of a finished profiler, through a file in
    the process's temporary directory."""
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])


def short_name(name: str) -> str:
    """A device operation's name without its arguments."""
    name = name.replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0][:120] or "unnamed"


def _stacks(host: list, points: list) -> list:
    """For each ``(ts, tag)`` of ``points``, the names of the ``host``
    events (nested intervals of one thread, as ``(ts, end, name)``) that
    cover it, outermost first."""
    host = sorted(host, key=lambda e: (e[0], -e[1]))
    out, stack, i = {}, [], 0
    for ts, tag in sorted(points):
        while i < len(host) and host[i][0] <= ts:
            while stack and stack[-1][1] <= host[i][0]:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] <= ts:
            stack.pop()
        out[tag] = [name for _, end, name in stack if end > ts]
    return [out[tag] for _, tag in points]


def union(spans: list) -> float:
    total, end = 0.0, None
    for t0, t1 in sorted(spans):
        if end is None or t0 > end:
            total += t1 - t0
            end = t1
        elif t1 > end:
            total += t1 - end
            end = t1
    return total


class Slice:
    """The device operations of the slice: ``ops``, dicts of ``name``,
    ``cat``, ``ts``, ``dur`` (microseconds) and ``callers`` (the Python
    functions that launched it, outermost first); ``window_s`` and
    ``busy_s``; ``scan_bp``, for each scan inside it the length of its
    sequence or the lengths of its set's records."""

    def __init__(self, events: list, scan_bp: list, device: int = 0):
        marks = [e for e in events if e.get("name") == RANGE and e.get("ph") == "X"
                 and e.get("cat") == "user_annotation"]
        if not marks:
            raise ValueError(f"no {RANGE} range in the trace")
        lo = float(marks[0]["ts"])
        hi = lo + float(marks[0]["dur"])
        self.scan_bp = list(scan_bp)
        self.window_s = (hi - lo) / 1e6
        ops = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
               and lo <= float(e["ts"]) <= hi
               and e.get("args", {}).get("device", device) == device]
        main = marks[0].get("tid")
        host = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)), e.get("name", ""))
                for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS
                and e.get("tid") == main]
        launch = {e["args"]["correlation"]: float(e["ts"]) for e in events
                  if e.get("cat") in ("cuda_runtime", "cuda_driver")
                  and "correlation" in e.get("args", {})}
        points = [(launch.get(e.get("args", {}).get("correlation"), -1.0), i)
                  for i, e in enumerate(ops)]
        callers = _stacks([h for h in host if not h[2].startswith("cuda")], points)
        self.ops = [{"name": short_name(e.get("name", "")), "cat": e["cat"],
                     "ts": float(e["ts"]), "dur": float(e.get("dur", 0.0)),
                     "callers": c} for e, c in zip(ops, callers)]
        spans = [(max(o["ts"], lo), min(o["ts"] + o["dur"], hi)) for o in self.ops]
        self.busy_s = union([s for s in spans if s[1] > s[0]]) / 1e6
        self._host, self._lo, self._hi = host, lo, hi

    def select(self, kernels=(), callers=(), cats=DEVICE_CATS) -> list:
        """The operations whose name matches a pattern of ``kernels`` or
        that a function matching a pattern of ``callers`` launched."""
        kr = [re.compile(p) for p in kernels]
        cr = [re.compile(p) for p in callers]
        return [o for o in self.ops if o["cat"] in cats and (
            any(r.search(o["name"]) for r in kr)
            or any(r.search(f) for r in cr for f in o["callers"]))]

    @staticmethod
    def seconds(ops: list) -> float:
        return sum(o["dur"] for o in ops) / 1e6

    def ms_per_scan(self, kernels=(), callers=(), cats=DEVICE_CATS):
        """The milliseconds of :meth:`select`'s operations per traced scan;
        ``None`` where it selects nothing."""
        ops = self.select(kernels, callers, cats)
        return self.seconds(ops) * 1e3 / len(self.scan_bp) if ops else None

    def top_ops(self, n: int = 10) -> list:
        by = {}
        for o in self.ops:
            by[o["name"]] = by.get(o["name"], 0.0) + o["dur"] / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]

    def idle_gaps(self, n: int = 10) -> list:
        """The idle time of the device inside the slice, summed by the
        innermost host function running at each gap's middle, the
        largest first."""
        gaps, end = [], self._lo
        for t0, t1 in sorted((o["ts"], o["ts"] + o["dur"]) for o in self.ops):
            if t0 > end:
                gaps.append((end, t0))
            end = max(end, t1)
        if self._hi > end:
            gaps.append((end, self._hi))
        labels = _stacks(self._host, [((a + b) / 2, i) for i, (a, b) in enumerate(gaps)])
        by = {}
        for (a, b), stack in zip(gaps, labels):
            label = stack[-1] if stack else "host idle"
            by[label] = by.get(label, 0.0) + (b - a) / 1e6
        return sorted(([k, v] for k, v in by.items()), key=lambda kv: -kv[1])[:n]
