"""Data-parallel genome scanning over a list of devices.

Counterpart of :mod:`lightmotif_tpu.parallel.mesh`.  The genome is split
into equal chunks, each extended with a halo of at least ``motif_len -
1`` symbols from its right neighbour (the overlap rule of the
reference's wrap rows, ``seq.rs:369-381``), so every window is scored by
exactly one shard.  Shard ``d`` owns window starts ``[d * chunk, (d + 1)
* chunk)``.

A mesh is an ordered list of :class:`torch.device` s; it may name one
device several times (8 x ``cuda:0`` puts 8 shards on one card).  Every
shard is issued before the host reads anything, as the JAX package's
``shard_map`` program runs every shard at once, so the host reads each
device a fixed number of times per call, whatever the number of shards:

* :func:`sharded_scan` and :meth:`ShardedScanner.collect` issue every
  shard's two-pass scan at a fixed capacity
  (:func:`~.ops.kernels.scan_segment`: the discrete pass, compaction,
  exact rescore and keep in one launch), from one thread, with no read;
  then each device lays its shards' counters and hit heads end to end,
  the first device gathers every device's, and the host reads once
  (:func:`~.scanner.kept_hits`).  Only when a shard's candidates
  outnumber the capacity (every shard that did runs once more at the
  next power of two at or above the worst shard's count, and a
  ``ShardedScanner`` keeps that capacity, as the JAX package's retry
  does) or its kept hits outgrow its head is the mesh read again;
* :func:`sharded_argmax` (exact f32 scores, K1, and the last-max
  reduction per shard) and :meth:`ShardedScanner.max` merge each
  shard's ``(max, position)`` on its device, then every device's pair on
  the mesh's first device -- the larger score wins, and among equal
  scores the larger position (the reference's last-max rule,
  ``pli/mod.rs:146``) -- and read the result once;
* :class:`ShardedMultiScanner` runs a :class:`~.scanner.MultiScanner`
  per distinct device (the prefilter K3 and the exact stages at fixed
  capacities, and K1 for dense motifs).  One thread issues every shard's
  steps with no read: in steady state one replay per device of a CUDA
  graph of all its shards' steps (:mod:`~.ops.graphs`), otherwise step
  by step, group by group across the devices, as the JAX package
  launches one program per group over the mesh; then
  each device merges and sorts its entries' counters and hit heads, the
  first device merges every device's, and the host reads once.  Only
  when an entry overflowed its capacities (or outgrew its head) is each
  device read in turn, and a device with such an entry re-runs it in a
  worker thread of its own.

:data:`HOST_READS` counts this module's reads of the device
(:func:`reset_host_reads` sets it to 0).

Across processes (``torch.distributed`` initialised by the caller with
the gloo or the NCCL backend), each process passes its own devices as
its mesh, the global shards go to the processes in contiguous blocks in
rank order, and each process returns the hits of its own shards, as the
JAX package does.  The small exchanges -- the shard blocks, the
per-shard hit counts and the argmax merge -- are all-gathers over the
default group: of host tensors under gloo, of tensors on the current
CUDA device under NCCL (each process calls ``torch.cuda.set_device``
before ``init_process_group``).  Other backends are refused.  Once a
process group is initialised the exchange runs, one rank included.

Both scans run at the JAX package's fixed capacities: the one-PSSM
scan's candidates per shard (:func:`sharded_scan`'s ``cap``; a
``ShardedScanner`` starts at 65,536 and ratchets) and the database
scan's capacities (``cap`` seeds them; they ratchet per device and
group).  ``pad_unit`` sets the shard alignment.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import functools
import threading

import numpy as np
import torch

from ..ops import kernels, multi, torch_ops
from ..ops.pipeline import PAD_MULTIPLE, DeviceSequence, resolve_device
from ..scanner import DEFAULT_CAPACITY, best_hit, issue_segment, kept_hits, merge_best
from ..sequence import EncodedSequence
from ..utils import profiling

__all__ = [
    "make_genome_mesh",
    "shard_sequence",
    "prepare_shards",
    "sharded_scan",
    "sharded_multi_scan",
    "sharded_argmax",
    "ShardedScanner",
    "ShardedMultiScanner",
]

#: Reads of the device (and of the exchange's result) by this module
#: since the last :func:`reset_host_reads`.
HOST_READS = 0
_READS_LOCK = threading.Lock()


def reset_host_reads() -> None:
    global HOST_READS
    with _READS_LOCK:
        HOST_READS = 0


def _count_read() -> None:
    global HOST_READS
    with _READS_LOCK:
        HOST_READS += 1


def _to_host(tensor: torch.Tensor) -> np.ndarray:
    """A tensor read to the host, counted in :data:`HOST_READS` (the
    database scan reads through its scanners' readers, counted too)."""
    _count_read()
    return multi.read_host(tensor)


def make_genome_mesh(devices=None) -> list:
    """The genome mesh: an ordered list of devices, one per shard.

    ``devices`` may repeat a device.  By default, every visible CUDA
    device, or the device chosen with ``use_device`` (``[cpu]`` after
    ``use_device("cpu")``); with neither it raises, like every entry
    point of the package."""
    from ..ops import pipeline

    if devices is None:
        if pipeline._CHOSEN is not None:
            return [pipeline._CHOSEN]
        pipeline.default_device()  # raises without a card
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    mesh = [resolve_device(d) for d in devices]
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


# -- processes ------------------------------------------------------------------


def _distributed():
    """``torch.distributed`` when a process group is initialised, else
    ``None``."""
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


def _all_gather(values) -> np.ndarray:
    """Every process's ``values`` (a same-shaped numpy array on each),
    stacked in rank order: ``[world, ...]``.  The collective runs
    whenever a process group is initialised, with one rank too."""
    local = np.ascontiguousarray(values)
    dist = _distributed()
    if dist is None:
        return local[None]
    backend = dist.get_backend()
    if backend == "gloo":
        device = torch.device("cpu")
    elif backend == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        raise RuntimeError(f"sharded scans across processes need the gloo or the nccl "
                           f"backend, not {backend}")
    mine = torch.as_tensor(local, device=device)
    every = [torch.empty_like(mine) for _ in range(dist.get_world_size())]
    dist.all_gather(every, mine)
    return _to_host(torch.stack(every))


def _shard_block(n_local: int) -> tuple:
    """(global shard count, this process's first shard): the processes'
    meshes laid end to end in rank order."""
    dist = _distributed()
    if dist is None:
        return n_local, 0
    sizes = _all_gather(np.asarray([n_local], np.int64))[:, 0]
    return int(sizes.sum()), int(sizes[: dist.get_rank()].sum())


def _gather_counts(local: dict, n_shards: int) -> np.ndarray:
    """This process's per-shard counts (``{global shard: count}``) merged
    with every other process's: int64 ``[n_shards]``."""
    counts = np.zeros(n_shards, np.int64)
    for d, c in local.items():
        counts[d] = c
    return _all_gather(counts).sum(axis=0)


def _best_everywhere(best):
    """The best of every process's ``best`` -- ``(score, position)`` or
    ``None`` -- by the last-max rule; ``None`` when no process has one.
    Exchanged as int64 ``(f32 bits, position)``."""
    row = [0, -1] if best is None else [int(np.float32(best[0]).view(np.int32)), best[1]]
    every = _all_gather(np.asarray(row, np.int64))
    every = every[every[:, 1] >= 0]
    if not len(every):
        return None
    scores = every[:, 0].astype(np.int32).view(np.float32)
    top = scores.max()
    return float(top), int(every[scores == top, 1].max())


def _merge_best(pairs: list):
    """Merge ``(score, position)`` scalar tensors by the last-max rule:
    those of each device on it, then each device's on the device of the
    first pair (copies on the current streams, so each is ordered after
    the work that made it), and one read.  Returns ``(score, position)``
    on the host, or ``None`` for no pairs."""
    if not pairs:
        return None
    top, position = merge_best(pairs)
    bits, position = _to_host(torch.stack([top.view(torch.int32).to(torch.int64), position]))
    return float(np.int32(bits).view(np.float32)), int(position)


# -- shards ---------------------------------------------------------------------


def _chunk_for(n_scores: int, n_shards: int, pad_multiple: int) -> int:
    """Window starts owned per shard: the per-shard share rounded up to
    the alignment unit."""
    chunk = -(-max(n_scores, 1) // n_shards)
    return max(-(-chunk // pad_multiple) * pad_multiple, pad_multiple)


def shard_sequence(
    encoded: np.ndarray,
    n_shards: int,
    motif_len: int,
    wildcard: int,
    pad_multiple: int = PAD_MULTIPLE,
    halo: int | None = None,
):
    """Split a flat encoded sequence into overlapping shards.

    Returns ``(shards[n_shards, chunk + halo] int8, chunk, n_scores)``
    where shard ``d`` owns window starts ``[d * chunk, (d+1) * chunk)``
    and carries ``halo`` (default ``motif_len - 1``) symbols from shard
    ``d+1``; a shard that starts past the sequence is all wildcard.  The
    same arrays as the JAX package's for the same arguments.
    """
    n = int(encoded.size)
    n_scores = max(n - motif_len + 1, 0)
    chunk = _chunk_for(n_scores, n_shards, pad_multiple)
    if halo is None:
        halo = motif_len - 1
    elif halo < motif_len - 1:
        raise ValueError(f"halo {halo} < motif_len - 1 = {motif_len - 1}")
    width = chunk + halo
    shards = np.full((n_shards, width), wildcard, dtype=np.int8)
    for d in range(n_shards):
        start = d * chunk
        stop = min(start + width, n)
        if start < n:
            shards[d, : stop - start] = encoded[start:stop]
    return shards, chunk, n_scores


def prepare_shards(encoded: np.ndarray, mesh: list, m: int, wildcard: int,
                   pad_unit: int | None = None):
    """Shard a genome and upload this process's shards once; returns
    ``(shards, chunk, n_scores)`` for :func:`sharded_scan`'s
    ``prepared`` argument, ``shards`` a list of ``(global shard index,
    uint8 tensor on its device)``.  Shards are aligned to ``pad_unit``
    (default :data:`~.ops.pipeline.PAD_MULTIPLE`) and carry a halo of
    whole units covering ``m - 1``."""
    unit = PAD_MULTIPLE if pad_unit is None else int(pad_unit)
    halo = max(1, -(-(m - 1) // unit)) * unit
    n_shards, first = _shard_block(len(mesh))
    rows, chunk, n_scores = shard_sequence(
        np.asarray(encoded), n_shards, m, wildcard, pad_multiple=unit, halo=halo)
    return [(first + i, torch.from_numpy(rows[first + i].view(np.uint8)).to(dev))
            for i, dev in enumerate(mesh)], chunk, n_scores


def _owned(n_scores: int, d: int, chunk: int) -> int:
    """Window starts shard ``d`` owns: ``clip(n_scores - d * chunk, 0,
    chunk)``."""
    return min(max(n_scores - d * chunk, 0), chunk)


def _per_device(array, mesh: list, dtype) -> dict:
    """One copy of a host table on each distinct device of the mesh."""
    host = np.ascontiguousarray(array, dtype=dtype)
    copies = (torch.as_tensor(host, device=dev) for dev in dict.fromkeys(mesh))
    return {t.device: t for t in copies}


def _tables(pssm_data, dm_data, mesh: list) -> dict:
    """``{device: (f32 table, u8 table)}`` on each distinct device."""
    pssm = _per_device(pssm_data, mesh, np.float32)
    dm = _per_device(dm_data, mesh, np.uint8)
    return {dev: (pssm[dev], dm[dev]) for dev in pssm}


def _counted(reader: multi.HostReader):
    """``read(tensor)`` through ``reader``, counted in :data:`HOST_READS`."""
    def read(tensor):
        _count_read()
        return reader.read(tensor)

    return read


def _issue_shards(tables: dict, prepared, t_scaled: int, threshold: float, m: int,
                  cap: int) -> list:
    """The segment kernel (:func:`~.ops.kernels.scan_segment`) on every shard that
    owns windows, at ``cap``, from this thread, with no read of any
    device: their :class:`~.scanner.Segment` s in shard order, each
    offset its shard's first window start, keyed by its global shard
    index."""
    shards, chunk, n_scores = prepared
    segments = []
    for d, shard in shards:
        n_local = _owned(n_scores, d, chunk)
        if n_local:
            segment = shard[: n_local + m - 1]
            pssm, dm = tables[segment.device]
            run = functools.partial(kernels.scan_segment, segment, n_local, dm, pssm,
                                    int(t_scaled), float(threshold))
            segments.append(issue_segment(run, d * chunk, d, cap))
    return segments


# -- one PSSM -------------------------------------------------------------------


def _sharded_scan(tables, prepared, threshold, t_scaled, m, n_local_shards, cap, hints,
                  reader) -> tuple:
    """The hits of this process's shards, read once in steady state
    (:func:`~.scanner.kept_hits`), and the kept count of every shard of
    every process (int64 ``[global shards]``).  Returns ``(positions,
    scores, shard counts, cap, reruns)``, ``cap`` the capacity the shards
    needed."""
    local = dict.fromkeys((d for d, _ in prepared[0]), 0)
    segments = _issue_shards(tables, prepared, t_scaled, threshold, m, cap)
    positions, scores, over = np.zeros(0, np.int64), np.zeros(0, np.float32), []
    if segments:
        positions, scores, cap, over, kept = kept_hits(segments, cap, hints, _counted(reader))
        local.update({s.key: int(k) for s, k in zip(segments, kept)})
    counts = _gather_counts(local, _shard_block(n_local_shards)[0])
    return positions, scores, counts, cap, len(over)


def sharded_scan(
    pssm_data: np.ndarray,
    dm_data: np.ndarray,
    encoded: np.ndarray,
    threshold: float,
    t_scaled: int,
    mesh: list | None = None,
    cap: int = 1 << 16,
    pad_unit: int | None = None,
    prepared=None,
):
    """Scan a genome across every device of the mesh; returns
    ``(positions int64, scores float32)`` of the accepted hits of this
    process's shards, ordered by position.

    ``pssm_data`` / ``dm_data``: the scoring matrix's f32 and its
    discrete matrix's u8 tables; ``t_scaled``: the threshold on the
    discrete scale; ``cap``: the candidates a shard holds (shards with
    more run once more at the next power of two at or above the worst
    shard's count).  ``prepared``: ``(shards, chunk, n_scores)`` from
    :func:`prepare_shards`, to scan an uploaded genome again.  One read
    when every shard fits ``cap`` and its head of
    :data:`~.ops.multi.HEAD_SLOTS` hits.
    """
    mesh = make_genome_mesh(mesh)
    m = pssm_data.shape[0]
    if int(cap) < 1:
        raise ValueError("cap must be positive")
    if prepared is None:
        prepared = prepare_shards(encoded, mesh, m, pssm_data.shape[1] - 1, pad_unit)
    tables = _tables(pssm_data, dm_data, mesh)
    positions, scores, *_ = _sharded_scan(tables, prepared, threshold, t_scaled, m, len(mesh),
                                          int(cap), {}, multi.HostReader())
    return positions, scores


def sharded_argmax(
    pssm_data: np.ndarray,
    encoded: np.ndarray,
    mesh: list | None = None,
    pad_unit: int | None = None,
):
    """Global ``(max_score, argmax)`` over a genome sharded across the
    mesh (and every process): the last maximum wins ties, across shards
    too.  ``(None, None)`` when the genome is shorter than the motif.
    Every shard's K1 and reduction are issued, merged on the devices,
    and read once."""
    mesh = make_genome_mesh(mesh)
    m = pssm_data.shape[0]
    shards, chunk, n_scores = prepare_shards(encoded, mesh, m, pssm_data.shape[1] - 1,
                                             pad_unit)
    if n_scores == 0:
        return None, None
    pssm_dev = _per_device(pssm_data, mesh, np.float32)
    best = []  # (max, global argmax) of each shard, on its device
    for d, shard in shards:
        n_local = _owned(n_scores, d, chunk)
        if n_local:
            scores = kernels.score_f32(shard, pssm_dev[shard.device], n_local)[:n_local]
            best.append((torch_ops.max_last(scores),
                         torch_ops.argmax_last(scores) + d * chunk))
    best = _best_everywhere(_merge_best(best))
    return (None, None) if best is None else best


class ShardedScanner:
    """Multi-device counterpart of :class:`~.scanner.Scanner`.

    The genome is sharded and uploaded once, with the PSSM's tables, at
    the first scan, and reused by every :meth:`collect` and :meth:`max`.
    :attr:`cap`, the candidates a shard holds, starts at the JAX
    package's 65,536 and ratchets to what the shards needed, so a steady
    call reads once on any number of devices (:data:`HOST_READS`);
    :attr:`reruns` counts the shards run again at a larger capacity.
    Every shard's hit buffers wait for the one read together, as the JAX
    mesh's sharded arrays do.  ``shard_hits`` holds the
    hits of every shard (of every process) after a :meth:`collect`."""

    def __init__(self, pssm, seq, threshold: float = 0.0,
                 mesh: list | None = None, pad_unit: int | None = None):
        self.pssm = pssm
        self.dm = pssm.to_discrete()
        self.threshold = float(threshold)
        self.mesh = make_genome_mesh(mesh)
        self.pad_unit = pad_unit
        self.cap = DEFAULT_CAPACITY
        if hasattr(seq, "unstripe"):
            seq = seq.unstripe()
        self.encoded = np.asarray(seq.data)
        self.shard_hits = None
        #: shards re-run at a larger capacity since the scanner was made
        self.reruns = 0
        self._prepared = None  # the sharded genome and the tables on the mesh
        self._hints = {}  # shard -> its last n_kept: the head widths
        self._reader = multi.HostReader()

    def _prep(self):
        if self._prepared is None:
            self._prepared = (
                prepare_shards(self.encoded, self.mesh, len(self.pssm),
                               self.pssm.alphabet.size - 1, self.pad_unit),
                _tables(np.asarray(self.pssm.data), np.asarray(self.dm.data), self.mesh))
        return self._prepared

    def collect(self) -> list:
        """The hits of this process's shards, ordered by position."""
        from ..scanner import Hit

        prepared, tables = self._prep()
        positions, scores, self.shard_hits, self.cap, reruns = _sharded_scan(
            tables, prepared, self.threshold, self.dm.scale(self.threshold),
            len(self.pssm), len(self.mesh), self.cap, self._hints, self._reader)
        self.reruns += reruns
        return [Hit(int(p), float(s)) for p, s in zip(positions, scores)]

    def max(self):
        """Best exact hit among the discrete candidates of every shard
        (the semantics of :meth:`~.scanner.Scanner.max`: the score may be
        below the threshold, ``scan.rs:200-249``); ties go to the larger
        position.  The shards' bests are merged on each device, then on
        the first (:func:`~.scanner.best_hit`), and read once.  Across
        processes, every process gets the global best."""
        from ..scanner import Hit

        prepared, tables = self._prep()
        # keep every discrete candidate: the f32 keep-filter is -inf
        segments = _issue_shards(tables, prepared, self.dm.scale(self.threshold), -np.inf,
                                 len(self.pssm), self.cap)
        best = None
        if segments:
            best, self.cap, over = best_hit(segments, self.cap, _counted(self._reader))
            self.reruns += len(over)
        best = _best_everywhere(best)
        return None if best is None else Hit(best[1], best[0])


# -- a motif database -----------------------------------------------------------


def _on_each_device(jobs: dict) -> dict:
    """Run ``jobs[device]()`` for every device at once, each in a worker
    thread of its own under ``torch.cuda.device(device)`` on that
    device's current stream (the idiom of
    ``torch.nn.parallel.parallel_apply``): a worker waiting on its device
    releases the GIL, so the other devices keep working.  Returns
    ``{device: result}`` in the order of ``jobs``, whatever the order in
    which the workers end; once every worker has ended, the first
    exception in that order is raised here."""
    def run(device, job):
        with torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext():
            return job()

    if not jobs:
        return {}
    with concurrent.futures.ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = {device: pool.submit(run, device, job) for device, job in jobs.items()}
    return {device: future.result() for device, future in futures.items()}


class _Binding:
    """A genome bound to a :class:`ShardedMultiScanner`: its chunk, the
    global shard count and this process's shards.  The CUDA graphs of
    its scans live as long as it does."""

    __slots__ = ("chunk", "n_shards", "shards", "__weakref__")

    def __init__(self, chunk: int, n_shards: int, shards: list):
        self.chunk, self.n_shards, self.shards = chunk, n_shards, shards


class ShardedMultiScanner:
    """Multi-device counterpart of :class:`~.scanner.MultiScanner`.

    One :class:`~.scanner.MultiScanner` per distinct device of the mesh
    holds the motif database, routed and packed on the host once and
    copied to each device (8 shards on one card pack once);
    :meth:`bind` / :meth:`collect` (or :meth:`scan`) then scan any
    number of genomes.  The genome is sharded once for every motif:
    ownership (``chunk``) from the shortest motif, each shard cut at
    ``chunk + m_max - 1`` symbols or at the genome's end, so every window
    a shard owns lies inside it whatever the motif's length.  Each shard
    is scanned by its device's ``MultiScanner`` (K3 and the exact stages
    for the motif groups, K1 for the dense motifs) with its windows cut at
    ``chunk`` on the device: a window past it belongs to the next shard.
    Hits come out ordered by (motif, position), those of this process's
    shards; ``shard_hits`` holds the hits of every shard of every process
    after a fetch.

    ``cap`` seeds the capacities of each device's scanner (they ratchet
    per group, shared by the device's shards); ``pad_unit`` sets the
    shard alignment; ``single_bucket`` buckets every group to the longest
    motif, as the CLI does.
    """

    def __init__(self, pssms, seq=None, thresholds=0.0,
                 mesh: list | None = None, cap: int = 1 << 16,
                 pad_unit: int | None = None,
                 single_bucket: bool = False):
        from ..scanner import MultiScanner

        self.pssms = list(pssms)
        if not self.pssms:
            raise ValueError("no motifs given")
        self.mesh = make_genome_mesh(mesh)
        self.cap = int(cap)
        self.pad_unit = pad_unit
        self.shard_hits = None
        self._scanners = {
            dev: MultiScanner(self.pssms, thresholds=thresholds, capacity=self.cap,
                              single_bucket=single_bucket, device=dev)
            for dev in dict.fromkeys(self.mesh)}
        # the database packed on the host once, now, and copied to each device
        first, *others = self._scanners.values()
        first._pack()
        for scanner in others:
            scanner._pack_from(first)
        self.lengths = next(iter(self._scanners.values())).lengths
        self._streams = {}  # device -> the streams its shards fork onto in a capture
        self._bound = None
        if seq is not None:
            self.bind(seq)

    def bind(self, encoded) -> "ShardedMultiScanner":
        """Shard a (new) genome onto the mesh; the packed motif database
        is reused."""
        if hasattr(encoded, "unstripe"):
            encoded = encoded.unstripe()
        if hasattr(encoded, "data"):
            encoded = encoded.data
        encoded = np.asarray(encoded)
        n = int(encoded.size)
        m_min, m_max = int(self.lengths.min()), int(self.lengths.max())
        n_shards, first = _shard_block(len(self.mesh))
        unit = PAD_MULTIPLE if self.pad_unit is None else int(self.pad_unit)
        chunk = _chunk_for(max(n - m_min + 1, 0), n_shards, unit)
        alphabet = self.pssms[0].alphabet
        shards = []
        for i, dev in enumerate(self.mesh):
            start = (first + i) * chunk
            if n - start >= m_min:  # a window to own
                part = EncodedSequence(encoded[start : start + chunk + m_max - 1], alphabet)
                shards.append((first + i, DeviceSequence(part, dev)))
        self._bound = _Binding(chunk, n_shards, shards)
        return self

    def _issue(self) -> dict:
        """Issue the scan of every shard, with no read of any device:
        ``{device: (entries, graphs)}`` in mesh order for every device
        with a step, each entry's offset
        a genome position, ``graphs`` what the device's entries are the
        outputs of (``None`` when they ran eagerly).  In steady state each
        device replays one CUDA graph of all its shards' steps
        (:meth:`_device_run`); otherwise the steps go out eagerly, group
        by group across the devices, as the JAX package launches one
        program per group over the mesh: every shard's (group, segment)
        step before any shard's next one, the dense motifs last.  One
        thread; each device's own current stream."""
        st = self._bound
        if st is None:
            raise ValueError("no sequence bound; use scan(seq)/bind(seq)")
        plans = {}  # device -> [(order, shard, step)]
        for d, dseq in st.shards:
            scanner = self._scanners[dseq.device]
            plans.setdefault(dseq.device, []).extend(
                (step[0], d, step) for step in scanner._steps(dseq, st.chunk))
        issued, eager = {}, []
        for device, plan in plans.items():
            plan.sort(key=lambda row: row[:2])
            scanner = self._scanners[device]
            graphs = (st, "shards", (tuple((d, order, scanner._caps(step[1]))
                                           for order, d, step in plan), int(scanner.SEGMENT)))
            if scanner.graphed() and scanner.replays.seen(*graphs, "steps"):
                entries, _ = scanner.replays.issue(
                    *graphs, "steps", functools.partial(self._device_run, device, plan))
                issued[device] = (entries, graphs)
            else:
                eager += [(order, d, device, step) for order, d, step in plan]
        eager.sort(key=lambda row: row[:2])
        for _, d, device, step in eager:
            issued.setdefault(device, ([], None))[0].append(
                self._queue(d, self._scanners[device], step))
        return {device: issued[device] for device in plans if device in issued}

    def _queue(self, d: int, scanner, step) -> multi.Entry:
        """Shard ``d``'s step on its device's scanner, on the current
        stream; the entry's offset a genome position."""
        entry = scanner._issue(step)
        return entry._replace(offset=entry.offset + d * self._bound.chunk)

    def _device_run(self, device, plan: list) -> list:
        """One device's steps (``plan``: ``(order, shard, step)`` rows),
        the work of its graph's capture: with several shards on the
        device, each shard's steps on a stream of its own, forked from the
        capture's stream and joined back, so that in the graph one shard's
        small kernels and the last waves of its prefilter overlap
        another's."""
        shards = list(dict.fromkeys(d for _, d, _ in plan))
        forks = {}
        if len(shards) > 1:
            current = torch.cuda.current_stream(device)
            pool = self._streams.setdefault(device, [])
            while len(pool) < len(shards):
                pool.append(torch.cuda.Stream(device))
            for d, stream in zip(shards, pool):
                stream.wait_stream(current)
                forks[d] = stream
        scanner = self._scanners[device]
        entries = []
        for _, d, step in plan:
            with torch.cuda.stream(forks.get(d)):
                entries.append(self._queue(d, scanner, step))
        for stream in forks.values():
            current.wait_stream(stream)
        return entries

    def _collect(self, device, entries: list, first) -> tuple:
        """The hits of one device's entries, given their first read: the
        re-runs of the entries that overflowed and the reads they need,
        through the device scanner's reader, counted in
        :data:`HOST_READS` (none when every entry fits)."""
        scanner = self._scanners[device]

        def read(tensor):
            _count_read()
            return scanner._reader.read(tensor)

        return multi.collect_device(entries, read, scanner._group_state,
                                    scanner._head_hint, first)

    def dispatch(self) -> dict:
        """Scan the bound genome on every shard and return a token for
        :meth:`fetch`.  :meth:`_issue` queues every device's steps from
        this thread; each device's entries' counters and hit heads are
        merged and sorted on it (:func:`~.ops.multi.sorted_heads`), and
        with several devices, those of all devices on the first one, so
        that a steady scan reads once (:meth:`_merged_hits`).  When an
        entry overflowed its capacities or outgrew its head, each device
        is read in turn and settles its entries in a worker of its own
        (:meth:`_device_hits`)."""
        st = self._bound
        issued = self._issue()
        heads = {device: self._scanners[device]._sorted_heads(entries, graphs)
                 for device, (entries, graphs) in issued.items()}
        hits = self._merged_hits(issued, heads) if len(heads) > 1 else None
        if hits is None:
            hits = self._device_hits(issued, heads)
        kept = np.bincount(hits[1] // st.chunk, minlength=st.n_shards)
        local = {d: int(kept[d]) for d, _ in st.shards}
        return {"hits": hits, "local": local, "n_shards": st.n_shards}

    def _merged_hits(self, issued: dict, heads: dict):
        """Every device's sorted heads copied to the first device (copies
        ordered with both devices' current streams), merged and sorted
        there (:func:`~.ops.multi.merge_sorted_heads`), and read once: the
        hit arrays, or ``None`` when an entry overflowed or outgrew its
        head.  Each device's capacities and head hints are kept as a
        settled read keeps them."""
        first = next(iter(heads))
        sizes = [len(issued[device][0]) for device in heads]
        merged = multi.merge_sorted_heads(
            [flat.to(first, non_blocking=True) for flat, _ in heads.values()], sizes)
        _count_read()
        counts, hits = multi.unpack_heads(self._scanners[first]._reader.read(merged), sum(sizes))
        per_device, at = [], 0
        for device, (_, widths) in heads.items():
            entries = issued[device][0]
            here, at = counts[at : at + len(entries)], at + len(entries)
            if not multi.fits(entries, here, widths):
                return None
            per_device.append((device, entries, here, widths))
        for device, entries, here, widths in per_device:
            scanner = self._scanners[device]
            multi.settle_entries(entries, here, widths, state=scanner._group_state,
                                 hints=scanner._head_hint)  # reads nothing: all fit
        return multi._hit_arrays(hits[:, : int(counts[:, 2].sum())])

    def _device_hits(self, issued: dict, heads: dict):
        """Each device's sorted heads read on its own, every read queued
        before any is waited on; a device whose entries do not all fit
        settles them (re-runs, more reads) in a worker of its own
        (:func:`_on_each_device`)."""
        pending = {device: self._scanners[device]._reader.queue(flat)
                   for device, (flat, _) in heads.items()}
        work, parts = {}, []
        for device, wait in pending.items():
            entries = issued[device][0]
            _count_read()
            first = (*multi.unpack_heads(wait(), len(entries)), heads[device][1])
            job = functools.partial(self._collect, device, entries, first)
            if multi.fits(entries, first[0], first[2]):
                parts.append(job())  # no read
            else:
                work[device] = job
        parts += _on_each_device(work).values()
        return multi.merge_hits(parts)

    def fetch_arrays(self, token):
        """Hit arrays ``(motif_ids int32, positions int64, scores
        float32)`` of a :meth:`dispatch` token, ordered by (motif,
        position); the per-shard counts go through the exchange."""
        self.shard_hits = _gather_counts(token["local"], token["n_shards"])
        return token["hits"]

    def fetch(self, token) -> list:
        """:meth:`fetch_arrays` as :class:`~.scanner.MultiHit` s."""
        from ..scanner import MultiHit

        return [MultiHit(int(mo), int(p), float(s))
                for mo, p, s in zip(*self.fetch_arrays(token))]

    def collect(self) -> list:
        return self.fetch(self.dispatch())

    def collect_arrays(self):
        with profiling.root_span("scanner.scan"):
            return self.fetch_arrays(self.dispatch())

    def scan(self, encoded) -> list:
        """``bind(encoded).collect()`` -- one call per genome."""
        return self.bind(encoded).collect()

    def scan_arrays(self, encoded):
        """``bind(encoded).collect_arrays()``."""
        with profiling.root_span("scanner.scan"):
            return self.bind(encoded).collect_arrays()


def sharded_multi_scan(
    pssms,
    encoded: np.ndarray,
    thresholds,
    mesh: list | None = None,
    cap: int = 1 << 16,
    pad_unit: int | None = None,
):
    """Scan many PSSMs over a genome sharded across the mesh: the
    one-shot form of :class:`ShardedMultiScanner`.  Returns a list of
    :class:`~.scanner.MultiHit` ordered by (motif, position)."""
    pssms = list(pssms)
    if not pssms:
        return []
    return ShardedMultiScanner(
        pssms, thresholds=thresholds, mesh=mesh, cap=cap,
        pad_unit=pad_unit).scan(encoded)
