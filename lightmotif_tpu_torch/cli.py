"""FIMO-like command-line scanner.

Counterpart of :mod:`lightmotif_tpu.cli`, with the same arguments and
output.  Like the reference CLI (``lightmotif-cli/src/main.rs``) it
loads motif matrices, derives per-motif thresholds from a p-value (MEME
score distribution), scans every FASTA record on the forward (and
optionally reverse-complement) strand, and streams hits as TSV with the
same columns::

    seq_index  seq_name  motif_index  motif_name  pos  strand  score  pvalue

Where the reference fans (motif x sequence) jobs over a thread pool,
this drives the device scan: one motif through the two-pass
:class:`~.scanner.Scanner`, several through the database scan
(:class:`~.scanner.MultiScanner`), and files of many records through
batched flights (:class:`~.batch.MultiBatchScanner`) that a reader
thread reads, encodes and uploads while the previous flight scans.
``--mesh`` shards each record's scan over every device of the genome
mesh instead (:class:`~.parallel.ShardedScanner`,
:class:`~.parallel.ShardedMultiScanner`), one record at a time.

The device is the port's (:func:`.ops.pipeline.default_device`): the
current CUDA device, or the one chosen with ``use_device``; without
either the CLI raises, it never runs on the CPU by itself.
``--compile-cache`` (the default) builds the CUDA kernels into the
cached build directory of :mod:`.ops.build`; ``--no-compile-cache``
into a fresh temporary one.
"""

from __future__ import annotations

import argparse
import json
import os
import queue
import sys
import threading
import time

import numpy as np
import torch

from . import __version__
from .alphabet import DNA, PROTEIN
from .dist import ScoreDistribution
from .fasta import read_fasta
from .io import load
from .ops import build
from .ops.pipeline import resolve_device
from .scanner import MultiScanner, Scanner
from .sequence import EncodedSequence

__all__ = ["main"]

#: Encoded bytes per streaming flight: the JAX CLI's default, kept so the
#: flag means the same.  The port's kernels take any length, so flights
#: are not padded to it.
DEFAULT_FLIGHT_BYTES = 16 << 20

def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="lightmotif-tpu-torch",
        description="Scan sequences for motif occurrences (FIMO-like).",
    )
    parser.add_argument("--version", action="version", version=__version__)
    parser.add_argument("-m", "--matrices", required=True, help="motif matrix file")
    parser.add_argument(
        "--format",
        default="jaspar",
        choices=("jaspar", "jaspar16", "transfac", "meme", "uniprobe"),
        help="format of the matrix file",
    )
    parser.add_argument("-s", "--sequences", required=True, help="FASTA sequence file")
    parser.add_argument("-o", "--output", required=True, help="output TSV file ('-' for stdout)")
    thr = parser.add_mutually_exclusive_group()
    thr.add_argument("-P", "--pvalue", type=float, default=None,
                     help="p-value threshold (default 1e-5)")
    thr.add_argument("--abs-threshold", type=float, default=None,
                     help="absolute score threshold")
    thr.add_argument("--rel-threshold", type=float, default=None,
                     help="threshold as a fraction of the maximum score")
    parser.add_argument("--direct", action=argparse.BooleanOptionalAction, default=True,
                        help="scan the direct strand")
    parser.add_argument("--reverse", action=argparse.BooleanOptionalAction, default=False,
                        help="also scan the reverse-complement strand")
    parser.add_argument("--protein", action="store_true", help="protein alphabet")
    parser.add_argument("--mesh", action="store_true",
                        help="shard each scan across all devices")
    parser.add_argument("-j", "--jobs", type=int, default=None,
                        help="accepted for reference-CLI compatibility; "
                        "the device scan is already parallel (use --mesh "
                        "for several devices)")
    parser.add_argument("--block-size", type=int, default=None,
                        help="positions per device dispatch")
    parser.add_argument("--compile-cache", action=argparse.BooleanOptionalAction,
                        default=True,
                        help="keep the built CUDA kernels on disk so repeat "
                        "runs skip nvcc (see also LIGHTMOTIF_TPU_COMPILE_CACHE); "
                        "--no-compile-cache builds into a temporary directory")
    parser.add_argument("--flight-bytes", type=int,
                        default=DEFAULT_FLIGHT_BYTES,
                        help="encoded bytes batched per device pass when "
                        "streaming many records (memory stays flat "
                        "regardless of file size)")
    parser.add_argument("-q", "--quiet", action="store_true")
    return parser


class _MotifJob:
    __slots__ = ("index", "name", "pssm", "reverse", "dist", "threshold")

    def __init__(self, index, name, pssm, reverse, dist, threshold):
        self.index = index
        self.name = name
        self.pssm = pssm
        self.reverse = reverse
        self.dist = dist
        self.threshold = threshold


def prepare_motifs(args) -> list:
    """Load matrices and derive thresholds (``main.rs:469-498``)."""
    jobs = []
    for i, motif in enumerate(load(args.matrices, format=args.format,
                                   protein=args.protein)):
        if motif.counts is not None:
            pssm = motif.counts.to_freq(0.1).to_scoring(None)
        elif motif.pssm is not None:
            pssm = motif.pssm
        else:
            continue
        dist = ScoreDistribution(pssm)
        if args.pvalue is not None:
            threshold = dist.score(args.pvalue)
        elif args.rel_threshold is not None:
            threshold = pssm.max_score() * args.rel_threshold
        elif args.abs_threshold is not None:
            threshold = args.abs_threshold
        else:
            threshold = dist.score(1e-5)
        reverse = pssm.reverse_complement() if args.reverse else None
        jobs.append(
            _MotifJob(i, motif.name or f"motif{i}", pssm, reverse, dist, threshold)
        )
    return jobs


def _scan(pssm, seq, threshold, args, device):
    if args.mesh:
        from .parallel import ShardedScanner

        return ShardedScanner(pssm, seq, threshold=threshold).collect()
    scanner = Scanner(pssm, seq, threshold=threshold, device=device)
    if args.block_size:
        scanner.block_size = args.block_size
    return scanner.collect()


def _build_strands(motifs, args):
    strands = []
    for job in motifs:
        if args.direct:
            strands.append((job, "+", job.pssm))
        if job.reverse is not None:
            strands.append((job, "-", job.reverse))
    return strands


def _scan_all(motifs, seq, args, device, cache=None):
    """Yield (job, strand, hit) for every motif/strand over one sequence.

    With multiple motifs all (motif, strand) matrices scan in one
    database pass (:class:`MultiScanner`, or its mesh counterpart
    :class:`~.parallel.ShardedMultiScanner` under ``--mesh``).  ``cache``
    (a dict) keeps the scanner, and with it the packed motif database,
    across records, so multi-record streams pay the database-preparation
    cost once."""
    strands = _build_strands(motifs, args)
    if len(strands) <= 1:
        for job, strand, pssm in strands:
            for hit in _scan(pssm, seq, job.threshold, args, device):
                yield job, strand, hit
        return
    key = "mesh" if args.mesh else "single"
    scanner = None if cache is None else cache.get(key)
    if scanner is None:
        pssms = [p for _, _, p in strands]
        thresholds = [job.threshold for job, _, _ in strands]
        if args.mesh:
            from .parallel import ShardedMultiScanner

            scanner = ShardedMultiScanner(pssms, thresholds=thresholds,
                                          single_bucket=True)
        else:
            scanner = MultiScanner(
                pssms, thresholds=thresholds,
                single_bucket=True,  # every group bucketed to the longest motif
                device=device,
            )
        if cache is not None:
            cache[key] = scanner
    for hit in scanner.scan(seq):
        job, strand, _ = strands[hit.motif]
        yield job, strand, hit


def _process_age_s():
    """Seconds since this process started (the imports happened in
    there)."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = float(fh.read().split()[21])
        with open("/proc/uptime") as fh:
            up = float(fh.read().split()[0])
        return up - start_ticks / os.sysconf("SC_CLK_TCK")
    except Exception:  # noqa: BLE001 - non-Linux
        return None


def _init_device():
    """The scan's device, with its CUDA context created (the first
    allocation and a synchronisation).  Raises when there is no card and
    no device was chosen."""
    device = resolve_device(None)
    if device.type == "cuda":
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
    return device


def main(argv=None) -> int:
    t_main = time.perf_counter()
    imports_s = _process_age_s()
    parser = build_parser()
    args = parser.parse_args(argv)
    build.use_compile_cache(args.compile_cache)
    alphabet = PROTEIN if args.protein else DNA

    # the CUDA context's creation, apart from the kernels' build and the
    # first scan (the first flight) so the warm-start floor decomposes
    t_dev = time.perf_counter()
    device = _init_device()
    device_init_s = time.perf_counter() - t_dev

    motifs = prepare_motifs(args)
    prep_s = time.perf_counter() - t_dev - device_init_s
    if not args.quiet:
        lens = [len(j.pssm) for j in motifs]
        prep = time.perf_counter() - t_main
        print(
            f"[{prep:8.2f}s] loaded {len(motifs)} matrices "
            f"(M={min(lens)}..{max(lens)})"
            if motifs
            else f"[{prep:8.2f}s] loaded 0 matrices",
            file=sys.stderr,
        )

    out = sys.stdout if args.output == "-" else open(args.output, "w")
    t0 = time.perf_counter()
    n_hits = 0

    def hit_row(seq_index, name, job, pos, strand, score, pv):
        # the one row format: the batched-flight and the solo paths both
        # emit through here, so they cannot drift
        return (f"{seq_index}\t{name}\t{job.index + 1}\t{job.name}\t"
                f"{pos}\t{strand}\t{np.float32(score)}\t{pv:e}\n")

    def write_hits(si, name, rows):
        nonlocal n_hits
        for job, strand, hit in rows:
            pv = job.dist.pvalue(hit.score)
            out.write(hit_row(si + 1, name, job, hit.position, strand,
                              hit.score, pv))
            n_hits += 1
        if not args.quiet:
            print(
                f"[{time.perf_counter() - t0:8.2f}s] {si + 1} sequences, "
                f"{n_hits} hits",
                file=sys.stderr,
            )

    try:
        out.write(
            "seq_index\tseq_name\tmotif_index\tmotif_name\tpos\tstrand\tscore\tpvalue\n"
        )
        strands = _build_strands(motifs, args)
        gap = max(max((len(p) for _, _, p in strands), default=1) - 1, 0)

        si = 0
        first = True
        batch_scanner = None  # persists across flights (packed motif DB)
        t_first = None
        bytes_first = 0
        bytes_total = 0

        def prepare_fn(seqs):
            # built lazily in the reader thread on the first batched
            # flight (single-record files never pay the packing cost)
            nonlocal batch_scanner
            if batch_scanner is None:
                from .batch import MultiBatchScanner

                batch_scanner = MultiBatchScanner(
                    [p for _, _, p in strands],
                    thresholds=[job.threshold for job, _, _ in strands],
                    single_bucket=True,
                    device=device,
                )
            return batch_scanner.prepare(seqs)

        if not strands or args.mesh:
            prepare_fn = None  # every record scans alone (sharded under --mesh)

        def emit_batched(flight, token):
            nonlocal si, n_hits
            rec, mo, local, sc = batch_scanner.fetch(token)
            # vectorized p-values, one lookup batch per motif
            pv = np.ones(sc.shape, np.float64)
            for mid in np.unique(mo):
                sel = mo == mid
                pv[sel] = strands[mid][0].dist.pvalues(sc[sel])
            order = np.lexsort((local, mo, rec))
            bounds = np.searchsorted(
                rec[order], np.arange(len(flight) + 1))
            for ri, (record, _) in enumerate(flight):
                lines = []
                for i in order[bounds[ri]:bounds[ri + 1]]:
                    job, strand, _ = strands[mo[i]]
                    lines.append(hit_row(si + 1, record.name, job,
                                         local[i], strand, sc[i], pv[i]))
                out.writelines(lines)
                n_hits += len(lines)
                si += 1
            if not args.quiet:
                print(
                    f"[{time.perf_counter() - t0:8.2f}s] {si} "
                    f"sequences, {n_hits} hits", file=sys.stderr)
            _account(flight)

        def _account(flight):
            nonlocal first, t_first, bytes_first, bytes_total
            flight_bytes = sum(len(s) for _, s in flight)
            bytes_total += flight_bytes
            if first:
                t_first = time.perf_counter() - t0
                bytes_first = flight_bytes
            first = False

        # one flight stays in flight: dispatch flight n+1's device scan
        # before fetching + formatting flight n's hits, so p-value
        # lookups and TSV writing overlap device work (each token holds
        # its own device buffers)
        pending = None
        scan_cache = {}  # packed motif DB persists across solo records
        for flight, prep in _read_flights(args, alphabet, gap, args.flight_bytes,
                                          prepare_fn):
            if prep is not None:
                token = batch_scanner.rebind_prepared(prep).dispatch()
                if pending is not None:
                    emit_batched(*pending)
                pending = (flight, token)
            else:
                if pending is not None:
                    emit_batched(*pending)
                    pending = None
                for record, seq in flight:
                    write_hits(si, record.name,
                               _scan_all(motifs, seq, args, device, scan_cache))
                    si += 1
                _account(flight)
        if pending is not None:
            emit_batched(*pending)
        if t_first is not None:
            steady_s = time.perf_counter() - t0 - t_first
            steady_bp = bytes_total - bytes_first
            print(json.dumps({
                "event": "cli_timing",
                "startup_s": round(t_first, 2),
                "steady_s": round(steady_s, 2),
                "steady_mbp_s": round(steady_bp / steady_s / 1e6, 1)
                if steady_s > 0 and steady_bp else None,
                # the warm-start floor: imports, the CUDA context, motif
                # preparation, and the first flight (kernel build or load,
                # packing, first upload and scan) = startup_s
                "imports_s": None if imports_s is None
                else round(imports_s, 2),
                "device_init_s": round(device_init_s, 2),
                "prep_s": round(prep_s, 2),
            }), file=sys.stderr)
    finally:
        if out is not sys.stdout:
            out.close()
    return 0


def _read_flights(args, alphabet, gap: int, flight_bytes: int,
                  prepare_fn=None):
    """Yield ``(records, prepared)`` flights of bounded size.

    An arbitrarily large FASTA streams through flights of at most
    ``flight_bytes`` encoded bytes at flat memory, each scanned in one
    device pass, while a background thread reads and encodes the next
    flight so host IO overlaps the device scan (the native encoder
    releases the GIL).  A record too big to batch comes out alone, with
    ``prepared`` None, and takes the segmented single-sequence path, as
    does a flight of one record.

    When ``prepare_fn(seqs)`` is given, the reader thread also
    concatenates and uploads each batched flight (``prepared`` is its
    return value), overlapping the host-to-device copy of flight ``n+1``
    with the device scan of flight ``n``.  The copy is queued on the
    device's default stream, the stream of every scan, so the scan that
    reads it runs after it.
    """
    q: "queue.Queue" = queue.Queue(maxsize=2)
    stop = threading.Event()

    def put(item) -> bool:
        """Enqueue unless the consumer has gone away (an early generator
        close must not leave this thread parked in a full queue)."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def produce():
        try:
            def emit(flight, solo) -> bool:
                prep = None
                if prepare_fn is not None and not solo and len(flight) > 1:
                    prep = prepare_fn([s for _, s in flight])
                return put((flight, prep))

            flight, total = [], 0
            for record in read_fasta(args.sequences):
                if stop.is_set():
                    return
                seq = EncodedSequence.encode_lossy(record.sequence, alphabet)
                need = len(seq) + gap
                if flight and total + need > flight_bytes:
                    if not emit(flight, False):
                        return
                    flight, total = [], 0
                if need > flight_bytes:
                    if not emit([(record, seq)], True):
                        return
                else:
                    flight.append((record, seq))
                    total += need
            if flight:
                emit(flight, False)
            put(None)
        except BaseException as e:  # surface reader errors in the main thread
            put(e)

    t = threading.Thread(target=produce, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if item is None:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()
        while not q.empty():  # unblock a parked producer
            try:
                q.get_nowait()
            except queue.Empty:
                break
        t.join(timeout=5)


if __name__ == "__main__":
    raise SystemExit(main())
