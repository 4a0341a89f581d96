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
  reference benches print).
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field

import torch

__all__ = ["profile_trace", "throughput", "ScanStats"]


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
