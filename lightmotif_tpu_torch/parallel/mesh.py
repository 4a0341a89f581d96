"""Data-parallel genome scanning over a list of devices.

Counterpart of :mod:`lightmotif_tpu.parallel.mesh`.  The genome is split
into equal chunks, each extended with a halo of at least ``motif_len -
1`` symbols from its right neighbour (the overlap rule of the
reference's wrap rows, ``seq.rs:369-381``), so every window is scored by
exactly one shard.  Shard ``d`` owns window starts ``[d * chunk, (d + 1)
* chunk)``.

A mesh is an ordered list of :class:`torch.device` s; it may name one
device several times (8 x ``cuda:0`` puts 8 shards on one card).  Each
shard runs the package's single-device code on its device: the two-pass
scan (:func:`~.ops.torch_ops.scan_segment`, the scoring kernel in
discrete mode, K2) for :func:`sharded_scan`, exact f32 scores (K1) and
the last-max reduction for :func:`sharded_argmax`, and a
:class:`~.scanner.MultiScanner` per device (the prefilter K3, and K1 for
dense motifs) for :class:`ShardedMultiScanner`.  Hits come to the host,
shifted by ``d * chunk``, and are merged; the argmax merge keeps the
larger score and, among equal scores, the larger position.

Across processes (``torch.distributed`` initialised by the caller with
the gloo backend), each process passes its own devices as its mesh, the
global shards go to the processes in contiguous blocks in rank order,
and each process returns the hits of its own shards, as the JAX package
does.  The small exchanges -- the argmax merge and the per-shard hit
counts -- are all-gathers of host tensors over the default group, which
works alike for CPU ranks and for ranks that share one card.  Other
backends are refused: none has been run across cards yet.

The JAX package's fixed-capacity hit buffers, their ratchets and retries
are not needed: compaction by ``nonzero`` is exact.  ``cap`` is accepted
for signature compatibility and unused, ``pad_unit`` sets only the shard
alignment, and no scan raises ``OverflowError``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import kernels, multi, torch_ops
from ..ops.pipeline import PAD_MULTIPLE, DeviceSequence, resolve_device
from ..sequence import EncodedSequence

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


def _world() -> tuple:
    """(rank, world size) of ``torch.distributed``; (0, 1) when it is
    not initialised."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _all_gather(values) -> np.ndarray:
    """Every process's ``values`` (a same-shaped numpy array on each),
    stacked in rank order: ``[world, ...]``."""
    local = np.asarray(values)
    _, world = _world()
    if world == 1:
        return local[None]
    import torch.distributed as dist

    if dist.get_backend() != "gloo":
        raise RuntimeError(f"sharded scans across processes need the gloo backend, "
                           f"not {dist.get_backend()}")
    t = torch.as_tensor(np.ascontiguousarray(local))
    out = [torch.empty_like(t) for _ in range(world)]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def _shard_block(n_local: int) -> tuple:
    """(global shard count, this process's first shard): the processes'
    meshes laid end to end in rank order."""
    rank, world = _world()
    if world == 1:
        return n_local, 0
    sizes = _all_gather(np.asarray([n_local], np.int64))[:, 0]
    return int(sizes.sum()), int(sizes[:rank].sum())


def _gather_counts(local: dict, n_shards: int) -> np.ndarray:
    """This process's per-shard counts (``{global shard: count}``) merged
    with every other process's: int64 ``[n_shards]``."""
    counts = np.zeros(n_shards, np.int64)
    for d, c in local.items():
        counts[d] = c
    return _all_gather(counts).sum(axis=0)


def _best_everywhere(rows):
    """The ``(score, position)`` row of every process's ``rows`` with the
    highest score, the larger position winning ties (the reference's
    last-max rule, ``pli/mod.rs:146``); ``None`` when there is none."""
    rows = np.asarray(rows, np.float64).reshape(-1, 2)
    top = (rows[np.lexsort((rows[:, 1], rows[:, 0]))[-1]] if len(rows)
           else np.asarray([-np.inf, -1.0]))  # position -1: no row
    every = _all_gather(top)
    every = every[every[:, 1] >= 0]
    return every[np.lexsort((every[:, 1], every[:, 0]))[-1]] if len(every) else None


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
    return {dev: torch.as_tensor(host, device=dev) for dev in dict.fromkeys(mesh)}


# -- one PSSM -------------------------------------------------------------------


def _sharded_scan(pssm_data, dm_data, encoded, threshold, t_scaled, mesh,
                  pad_unit, prepared):
    """:func:`sharded_scan`, also returning the hits of every shard of
    every process (int64 ``[global shards]``)."""
    mesh = make_genome_mesh(mesh)
    m = pssm_data.shape[0]
    wildcard = pssm_data.shape[1] - 1
    shards, chunk, n_scores = prepared if prepared is not None else prepare_shards(
        encoded, mesh, m, wildcard, pad_unit)
    pssm_dev = _per_device(pssm_data, mesh, np.float32)
    dm_dev = _per_device(dm_data, mesh, np.uint8)
    parts_pos, parts_sc, local = [], [], {}
    for d, shard in shards:
        n_local = _owned(n_scores, d, chunk)
        if n_local == 0:
            continue
        dev = shard.device
        positions, scores = torch_ops.scan_segment(
            shard[: n_local + m - 1], n_local, dm_dev[dev], pssm_dev[dev],
            int(t_scaled), float(threshold))
        parts_pos.append(positions.cpu().numpy() + d * chunk)
        parts_sc.append(scores.cpu().numpy())
        local[d] = len(parts_pos[-1])
    shard_hits = _gather_counts(local, _shard_block(len(mesh))[0])
    if not parts_pos:
        return np.zeros(0, np.int64), np.zeros(0, np.float32), shard_hits
    positions = np.concatenate(parts_pos)
    order = np.argsort(positions, kind="stable")
    return positions[order], np.concatenate(parts_sc)[order], shard_hits


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
    discrete scale.  ``prepared``: ``(shards, chunk, n_scores)`` from
    :func:`prepare_shards`, to scan an uploaded genome again.  ``cap`` is
    unused (compaction is exact).
    """
    positions, scores, _ = _sharded_scan(pssm_data, dm_data, encoded, threshold,
                                         t_scaled, mesh, pad_unit, prepared)
    return positions, scores


def sharded_argmax(
    pssm_data: np.ndarray,
    encoded: np.ndarray,
    mesh: list | None = None,
    pad_unit: int | None = None,
):
    """Global ``(max_score, argmax)`` over a genome sharded across the
    mesh (and every process): the last maximum wins ties, across shards
    too.  ``(None, None)`` when the genome is shorter than the motif."""
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
        if n_local == 0:
            continue
        scores = kernels.score_f32(shard, pssm_dev[shard.device], n_local)[:n_local]
        best.append((torch_ops.max_last(scores), torch_ops.argmax_last(scores) + d * chunk))
    gmax, garg = _best_everywhere([[float(mx), float(am)] for mx, am in best])
    return float(gmax), int(garg)


class ShardedScanner:
    """Multi-device counterpart of :class:`~.scanner.Scanner`.

    The genome is sharded and uploaded once, at the first scan, and
    reused by every :meth:`collect` and :meth:`max`.  ``shard_hits``
    holds the hits of every shard (of every process) after a scan."""

    def __init__(self, pssm, seq, threshold: float = 0.0,
                 mesh: list | None = None, pad_unit: int | None = None):
        self.pssm = pssm
        self.dm = pssm.to_discrete()
        self.threshold = float(threshold)
        self.mesh = make_genome_mesh(mesh)
        self.pad_unit = pad_unit
        if hasattr(seq, "unstripe"):
            seq = seq.unstripe()
        self.encoded = np.asarray(seq.data)
        self.shard_hits = None
        self._prepared = None  # the sharded genome on the mesh

    def _prep(self):
        if self._prepared is None:
            self._prepared = prepare_shards(
                self.encoded, self.mesh, len(self.pssm),
                self.pssm.alphabet.size - 1, self.pad_unit)
        return self._prepared

    def _scan(self, threshold: float):
        positions, scores, self.shard_hits = _sharded_scan(
            np.asarray(self.pssm.data), np.asarray(self.dm.data), self.encoded,
            threshold, self.dm.scale(self.threshold), self.mesh, self.pad_unit,
            self._prep())
        return positions, scores

    def collect(self) -> list:
        """The hits of this process's shards, ordered by position."""
        from ..scanner import Hit

        positions, scores = self._scan(self.threshold)
        return [Hit(int(p), float(s)) for p, s in zip(positions, scores)]

    def max(self):
        """Best exact hit among the discrete candidates of every shard
        (the semantics of :meth:`~.scanner.Scanner.max`: the score may be
        below the threshold, ``scan.rs:200-249``); ties go to the larger
        position.  Across processes, every process gets the global
        best."""
        from ..scanner import Hit

        positions, scores = self._scan(-np.inf)  # keep every discrete candidate
        best = _best_everywhere(np.stack([scores.astype(np.float64), positions], axis=1))
        return None if best is None else Hit(int(best[1]), float(best[0]))


# -- a motif database -----------------------------------------------------------


class ShardedMultiScanner:
    """Multi-device counterpart of :class:`~.scanner.MultiScanner`.

    One :class:`~.scanner.MultiScanner` per distinct device of the mesh
    routes and packs the motif database once (8 shards on one card pack
    once); :meth:`bind` / :meth:`collect` (or :meth:`scan`) then scan any
    number of genomes.  The genome is sharded once for every motif:
    ownership (``chunk``) from the shortest motif, each shard cut at
    ``chunk + m_max - 1`` symbols or at the genome's end, so every window
    a shard owns lies inside it whatever the motif's length.  Each shard
    is scanned by its device's ``MultiScanner`` (K3 and the exact stages
    for the motif groups, K1 for the dense motifs) and keeps the hits at
    positions below ``chunk``.  Hits come out ordered by (motif,
    position), those of this process's shards; ``shard_hits`` holds the
    hits of every shard of every process after a fetch.

    ``cap`` is unused (compaction is exact); ``pad_unit`` sets the shard
    alignment; ``single_bucket`` buckets every group to the longest
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
            dev: MultiScanner(self.pssms, thresholds=thresholds,
                              single_bucket=single_bucket, device=dev)
            for dev in dict.fromkeys(self.mesh)}
        for scanner in self._scanners.values():
            scanner._pack()  # one packed database per distinct device, now
        self.lengths = next(iter(self._scanners.values())).lengths
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
        self._bound = {"chunk": chunk, "n_shards": n_shards, "shards": shards}
        return self

    def dispatch(self) -> dict:
        """Scan the bound genome on every shard and return a token for
        :meth:`fetch`; the token holds the hits on the devices."""
        st = self._bound
        if st is None:
            raise ValueError("no sequence bound; use scan(seq)/bind(seq)")
        chunk = st["chunk"]
        parts, local = [], {}
        for d, dseq in st["shards"]:
            found = self._scanners[dseq.device].bind(dseq).dispatch()["parts"]
            local[d] = 0
            if not found:
                continue
            pos, ids, scores = (torch.cat(column) for column in zip(*found))
            own = pos < chunk  # the rest belongs to the next shard
            parts.append((pos[own] + d * chunk, ids[own], scores[own]))
            local[d] = int(parts[-1][0].shape[0])
        return {"parts": parts, "local": local, "n_shards": st["n_shards"]}

    def fetch_arrays(self, token):
        """Hit arrays ``(motif_ids int32, positions int64, scores
        float32)`` of a :meth:`dispatch` token, ordered by (motif,
        position)."""
        by_device = {}
        for part in token["parts"]:
            by_device.setdefault(part[0].device, []).append(part)
        host = [tuple(torch.cat(column).cpu() for column in zip(*parts))
                for parts in by_device.values()]
        self.shard_hits = _gather_counts(token["local"], token["n_shards"])
        return multi.sorted_hits(host)

    def fetch(self, token) -> list:
        """:meth:`fetch_arrays` as :class:`~.scanner.MultiHit` s."""
        from ..scanner import MultiHit

        return [MultiHit(int(mo), int(p), float(s))
                for mo, p, s in zip(*self.fetch_arrays(token))]

    def collect(self) -> list:
        return self.fetch(self.dispatch())

    def collect_arrays(self):
        return self.fetch_arrays(self.dispatch())

    def scan(self, encoded) -> list:
        """``bind(encoded).collect()`` -- one call per genome."""
        return self.bind(encoded).collect()

    def scan_arrays(self, encoded):
        """``bind(encoded).collect_arrays()``."""
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
