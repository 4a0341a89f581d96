"""CUDA graphs of the database scan's steady work.

The JAX package runs each motif group's segment as one compiled
program.  The port's counterpart is a CUDA graph (``torch.cuda.CUDAGraph``)
of a whole dispatch on one device -- every (group, segment) step (the
prefilter, the candidates' compaction, phase C, the pairs kernel and the
small torch ops between them) and every dense motif -- and one of the
fetch's merge and sort, so that a steady scan issues one launch per
device where it issued some twenty per step.

The graphs of an ``owner`` (a bound sequence, whose lifetime bounds
them) and a ``tag`` (what else tells its dispatches apart) are kept at
one ``key`` at a time (the steps and their capacities): a new key drops
the last one's graphs, so a capacity that grows leaves nothing behind.
Under a key each piece of work (``name``) runs eagerly at its first
issue (which also sets each kernel's attributes on the device), is
captured on a side stream of its device at its second, and replayed
after that.  A sequence scanned once is never captured.  A graph's
outputs are static tensors, which each replay writes again (with the same
values: a key's work depends only on its inputs and capacities).  Nothing
falls back: a capture that fails raises.

The graphs of a key share one memory pool.  A capture reuses the memory
its own work frees and the scratch of the graphs captured before it
(never their outputs, which stay allocated), so the dispatch's graph and
the merge that reads its outputs hold together about what one eager scan
needs at its peak, not the sum of both peaks.  A later graph's outputs
may lie in an earlier one's scratch: they are valid until an earlier
graph of the key replays again, and a caller reads them before that (the
fetch reads the merge's output as soon as it is replayed).

A kernel wrapper called while a graph is recorded launches nothing; it
adds to the recording's tally (:func:`.kernels.recording`), and each
replay counts the tally's launches (:func:`.kernels.count_replay`).

Nothing here runs on the CPU: a caller issues CPU work eagerly.
"""

from __future__ import annotations

import weakref
from typing import Callable

import torch

from ..utils import profiling
from . import kernels

__all__ = ["Replays"]


class _Graph:
    __slots__ = ("graph", "out", "tally")

    def __init__(self, graph, out, tally):
        self.graph, self.out, self.tally = graph, out, tally


#: The state of work issued once: run eagerly, captured at the next issue.
_WARM = object()

#: Where a key's work keeps the memory pool its graphs share.
_POOL = object()


class Replays:
    """The CUDA graphs of one device, per (owner, tag) at one key.
    :attr:`captured` and :attr:`replayed` count the captures and the
    replays."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self._sets = weakref.WeakKeyDictionary()  # owner -> {tag: (key, {name: state})}
        self._stream = None  # the side stream captures run on
        self.captured = 0
        self.replayed = 0

    def _work(self, owner, tag, key) -> dict:
        """``{name: _WARM | _Graph | memo}`` of (``owner``, ``tag``) at
        ``key``, and its graphs' memory pool; a new key drops the last
        key's."""
        sets = self._sets.setdefault(owner, {})
        held = sets.get(tag)
        if held is None or held[0] != key:
            held = sets[tag] = (key, {})
        return held[1]

    def holds(self, owner, tag, key, name, out) -> bool:
        """Whether (``owner``, ``tag``) holds, at ``key``, a graph of the
        work ``name`` whose outputs are ``out``: work that reads them may
        be captured with them (outputs of a dropped graph are read
        eagerly)."""
        held = self._sets.get(owner, {}).get(tag)
        step = held[1].get(name) if held is not None and held[0] == key else None
        return isinstance(step, _Graph) and step.out is out

    def seen(self, owner, tag, key, name) -> bool:
        """Whether ``name`` was issued before under (``owner``, ``tag``) at
        ``key``, so that its next issue replays a graph; records that it
        has been now."""
        work = self._work(owner, tag, key)
        if name in work:
            return True
        work[name] = _WARM
        return False

    def issue(self, owner, tag, key, name, fn: Callable, stream=None) -> tuple:
        """``(fn(), replayed)`` for the work ``name`` of (``owner``,
        ``tag``) at ``key``: eagerly at its first issue, else from its
        graph (captured at its second), replayed on ``stream`` (default:
        the device's current stream; span ``scanner.replay``).  When it
        replays, the tensors of what it returns are the graph's
        outputs."""
        if not self.seen(owner, tag, key, name):
            return fn(), False
        work = self._work(owner, tag, key)
        step = work[name]
        if step is _WARM:
            if _POOL not in work:
                work[_POOL] = torch.cuda.graph_pool_handle()
            step = work[name] = self._capture(fn, work[_POOL])
        with (profiling.span("scanner.replay"), torch.cuda.device(self.device),
              torch.cuda.stream(stream)):
            step.graph.replay()
        kernels.count_replay(step.tally)
        self.replayed += 1
        return step.out, True

    def memo(self, owner, tag, key, name, fn: Callable):
        """``fn()``, computed once per (``owner``, ``tag``, ``key``,
        ``name``) and kept with those graphs: what a capture needs that
        must not be made inside it (an upload from pageable memory)."""
        work = self._work(owner, tag, key)
        if name not in work:
            work[name] = fn()
        return work[name]

    def _capture(self, fn: Callable, pool) -> _Graph:
        """Record ``fn()``'s work into a new graph on the side stream, its
        memory in ``pool``.  Raises what the capture raised."""
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        graph, tally = torch.cuda.CUDAGraph(), []
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            with kernels.recording(tally):
                graph.capture_begin(pool=pool)
                try:
                    out = fn()
                except BaseException:
                    try:
                        graph.capture_end()
                    except RuntimeError:
                        pass  # the first error is the one to raise
                    raise
                graph.capture_end()
        self.captured += 1
        return _Graph(graph, out, tally)
