#!/usr/bin/env python
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --mesh-only   # phases 1-2, 5, 8, 16-17, 23's mesh
    python3 chip_smoke.py --scale-only  # phases 1-2, 23 with its sweeps
    python3 chip_smoke.py --mesh-only --parent DIR  # and phase 22
    python3 chip_smoke.py --parent DIR  # all, then phase 22 against DIR
    python3 chip_smoke.py --stages-only --parent DIR  # phases 1-3, 22
    python3 chip_smoke.py --one-pssm-cards [--parent DIR]  # 1-2, 5, 16's
        # one-PSSM sharded scans on 1..N cards, 22's one-PSSM walls
    python3 chip_smoke.py --segment-times [--parent DIR]  # 1, the build,
        # 3's and 4's segment kernel checks, 5, 20's segment kernel at its
        # two shapes (beside the parent's K2 + C3), 23's MX000001 on the
        # chromosome and its profiled kernels

Phases, one line of output each (any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; every module of the port imported, with no JAX;
2. build: ``nvcc`` compiles ``lightmotif_tpu_torch/ops/csrc/*.cu`` for
   ``sm_90a``, one process per source, all at once: first the production
   build (``score.cu``, ``scan.cu``, ``prefilter.cu``, ``phase_c.cu``, ``pairs.cu``),
   then the probe build (``probes.cu``), each with its own seconds;
3. SASS: ``cuobjdump -sass`` of the prefilter library, the tensor-core
   instructions (``IMMA``) of every instantiation of the tensor-core
   prefilter, the production one and P9's bits form included (each must
   hold some; the lookup kernel of probe P7 holds none), and phase C's
   kernel (``phase_c.cu``); of the scoring library, K1's production
   instantiation adds with ``FADD`` and has no ``FFMA`` (no
   contraction), K2's looks up with ``PRMT``; the pairs library and both
   forms of the segment kernel (``scan.cu``) add with ``FADD`` and have
   no ``FFMA``; the ``ptxas -v`` registers and spills of phase C's, the
   pairs library's and the segment kernel's kernels;
4. K1 and K2 against their plain PyTorch versions on the card
   (``torch.equal``): DNA (through the production instantiations, and the
   generic one past K2's m = 257), protein, k = 7 and k = 256 tables,
   random sequences with ranks >= K and wildcard runs, ragged
   ``n_scores``, and the main path's own shapes; then the segment kernel,
   the Scanner's discrete pass, compaction, rescore and keep in one
   launch (``scan.cu``), against its plain version (``torch.equal`` of the
   counters, the kept hits and the best of them): DNA, protein, k = 7 and
   k = 256 tables, m = 1 and m = 300, no candidate, capacities of 1,
   below, at and above the count and on and inside a tile's candidates,
   threshold -inf, ragged lengths, wildcard runs, exact zero sums (+0.0
   bits), and the genome's one segment at p = 1e-5 and at p = 1e-2 (kept
   hits past a Scanner's first head);
5. the main path at full size: an E. coli-sized genome (4,641,652 bp,
   seed 0xECC011) against PRODORIC MX000001 -- full-genome bit parity
   of ``pssm.score`` with the sequential host oracle, the known best
   hit (position 3,254,602, f32 bits 0x4197E448, which must win the
   exact tie with position 2,558,379, in ``score_max`` and in
   ``Scanner.max``), ``Pipeline.score_discrete`` (K2 once) against the
   host's clamped sums, and the two-pass ``Scanner`` at p = 1e-5 against
   the host brute force, in one segment, in five, and seeded at a
   capacity of 4, which must ratchet; the segment kernel once per
   segment and re-run, K2 never; a steady ``collect`` and ``max`` read the card once each, and
   the issue never (sync debug mode "error"); every kernel of the path
   must have been launched by this phase;
6. K3, the multi-motif prefilter on the int8 tensor cores, against its
   plain version (``torch.equal`` on every window that fits): DNA
   groups of 16, 256 (ragged lengths) and 2,048 motif lanes with m_max
   2 to 128 (1, 2, 3 and 8 contraction blocks), protein groups with
   m_max 5 and 32, never-pass lanes, sequences with wildcard runs;
7. K4 (u8, one byte plane) and K5 (u16, two), the other two
   prefilters, against their plain versions on the same groups and
   sequences, and K4 at the shape of ``bench.py:123-130`` (1,024 lanes
   of m = 15, thresholds 2,400 written by hand) over the genome;
8. the database path at full size: a seeded synthetic stand-in for
   JASPAR2024 (2,346 DNA motifs of lengths 5-35, 20 Dirichlet(0.5)
   sites each, pseudocount 0.1, both strands = 4,692 PSSMs, thresholds
   at p = 1e-6) scanned over the genome by ``MultiScanner.scan_arrays``
   in one segment and in five, each equal to a per-PSSM brute force on
   the card (K1 + threshold: positions and f32 bits, -0.0 read as
   +0.0); the device memory that a steady scan's CUDA graphs keep,
   beside one eager scan's peak, on 2 and 8 segments of one size
   (``graph_memory``); K3, phase C (``lm_phase_c_bits``) and the pairs kernel
   (``lm_pairs_rescore``, two kernels a call, each counted) once per
   group and once per re-run at larger capacities; a scanner seeded at a capacity of 64 ratchets to the same
   hits; a steady ``collect_arrays`` reads the card once, and its
   dispatch reads it never (sync debug mode "error") and replays the
   CUDA graph of its steps (captures and replays counted); then phase C and
   the pairs kernel ``torch.equal`` to their plain versions on every
   group (bits, counters, positions, lanes, f32 bits) with each group's
   candidate, pair and kept counts, times, launches and bounds;
9. the prefilter modes at full size, through the package's
   ``multi.route_motifs``, ``multi.database_groups`` and
   ``multi.scan_groups``: the same database through the u16 (K5) mode
   in 1 and 5 segments, equal to the K3 mode and the brute force, and
   through the u8 (K4) mode in groups of 512 lanes, equal to the K3
   mode (the genome has no wildcard); each must launch its kernel,
   phase C and the pairs kernel once per group and segment and once per
   re-run.  In each mode the segment entry
   ``multi.scan_multi_segment_fused``, given the first group's JAX
   filters, must give that group's hits with one launch of each; phase C
   and the pairs kernel equal their plain versions on every group of
   both modes;
10. the dense path (four DNA motifs of m 129-257) and a protein database
    (200 motifs of m 5-40 over 1,000,000 residues) against the same
    brute force; each scan must have launched K1 once per dense motif
    and K3 once per motif group; phase C and the pairs kernel equal their
    plain versions on every protein group, and on a group of dense hits
    (p = 0.02) whose rows hold more pairs than a row lists;
11. batched records: the genome cut into seeded records of 50-2,000 bp
    (some shorter than the motif) through ``BatchReducer`` (against the
    per-record host oracle), ``BatchScanner`` at p = 1e-5 (against
    per-record Scanners) and ``MultiBatchScanner`` with the database
    (against the brute force over the concatenation, windows inside one
    record); each class's launches are counted from 0 over its own call
    and must be K1 once, the segment kernel once per segment and K3,
    phase C and the pairs kernel once per motif group and segment;
12. the FIMO-like CLI through its files: the database written as a
    JASPAR16 file, the genome and the records as FASTA, MX000001 as a
    one-motif file.  In this process (``cli.main``, launch counts reset
    before each run): database x genome at p = 1e-6 on both strands equal
    to the brute force of phase 8 through the prefilter; database x
    records in one flight and in several, byte-identical TSVs equal to
    the batch phase's ``MultiBatchScanner`` hits, the prefilter launched
    once per group and flight segment; MX000001 x genome at p = 1e-5 equal
    to phase 5's Scanner hits through K2.  Then ``python -m
    lightmotif_tpu_torch.cli`` cold (a fresh build directory) and warm:
    no ``probes.cu`` in the cold build, no JAX imported, the same TSV;
    and ``--mesh`` (the default mesh), database x genome and MX000001 x
    genome, each TSV equal to the solo run's;
13. exact TFM-PVALUE: MX000001's score at p = 1e-5 by TFM-PVALUE and by
    the MEME distribution, with their host seconds;
14. the host Gibbs sampler (``sampler.Sampler``): 16 sequences of 40,000
    bp and 16 of 500 bp with MX000001's first site planted, 200 OOPS
    steps on the card and on the CPU from one numpy seed: identical
    trajectories (hold-out, starts, active set, counts) at every step,
    K1 launched once per long hold-out drawn and equal there to its
    plain version and ``score_host``; seconds per step on each device;
15. the batched sampler (``sampler_batch``) on the card, OOPS and ZOOPS,
    64 chains over 200 seeded peak-like sequences of 100-500 bp with a
    width-10 site planted: 100 steps and a resume of 100 bit-identical
    to 200, the planted site recovered by a 1,200-step run (about six
    sweeps of the sequences), seconds per step;
16. the sharded scans (``parallel``) at full width on 8 shards of the
    card: ``ShardedScanner`` equal to phase 5's Scanner hits (the segment
    kernel once per shard), its ``max`` and ``sharded_argmax`` the known
    best hit, which wins its tie across shards 4 and 5; one read per
    steady ``collect`` and ``max``, every shard's segment kernel issued
    under the
    sync debug mode "error"; ``ShardedMultiScanner`` with the database, on
    the 8 shards and on the default mesh, equal to ``MultiScanner`` and
    the brute force (K3, phase C and the pairs kernel once per group and
    shard); its issue (every shard's steps, graph replays) under the
    sync debug mode "error"; the dense motifs of phase 10 through the mesh (K1
    once per motif and shard); the host reads of one call on 1 and 8
    shards (never more on 8; one for the steady database scan, and one
    for ``MultiScanner.collect_arrays``); the loops over shards under the
    sync debug mode "error" (no read of the card between shards); walls
    at 1, 2, 4 and 8 shards beside the
    single-device walls of the same call; with two or more cards, the
    default mesh over every card equal to one card, the sync debug checks
    on every card (the sharded scan's loops, the database scan's issue
    and each card's ``MultiScanner.dispatch``), walls on 1..N cards,
    where each card's time goes in one profiled run of the database scan
    (busy, first and last kernel, idle, and what each host thread was
    doing meanwhile), and the CLI's ``--mesh`` database x genome run on
    every card beside the first card alone (else ``multi_card: not run``);
17. processes joined with ``torch.distributed``: two gloo processes on
    the card, four shards each; one NCCL process of 8 shards, which
    builds the kernels from an empty directory under two threads at
    once; with two or more cards, two NCCL processes, one card each.
    Their merged hits equal the single-process hits, every rank reports
    the known best hit and the same per-shard counts, and each path
    launches its kernel once per shard; every rank's walls and its
    database scan's split by stage are logged.
18. times on the card (CUDA events, median of 15 samples after a
    warm-up), each kernel beside its plain version, its bound (the least
    time the card could take: bytes over HBM's rate or operations over
    the card's peak) and a ``conv1d`` library yardstick: device time per
    launch (launches queued behind a GPU spin), and one call with the
    host's launch cost; then ``score_max``, the Scanner's wall time (a
    fresh scanner; a resident one, steady, and its idle share in one
    profiled run), the segment kernel at the genome and at one 2**26-start
    chromosome segment beside its plain version and bound, K3,
    K4 and K5 at their shapes, the database scan's steady-state wall
    beside the plain stages' (K3, then the plain versions of phase C and
    the pairs kernel) in the same call, in the K3 and u16 modes and, from
    one more run through the scanner's timing hook and ``torch.profiler``
    after a warm-up run, its split by stage, device-busy time (the trace's
    device events) and host time, then the same of the steady path (graph
    replays, no hook); the batch classes' walls (``BatchScanner`` with its
    reads);
19. the host's part of one ``kernels.score_f32`` call (median enqueue
    time of 400 calls) beside the earlier wrapper's per-call work and the
    kernel's device time;
20. the prefilter probes (``lightmotif_tpu_torch.probes.prefilter``),
    each checked once against its plain version with its launches
    counted from 0, then timed: P6, the tensor cores' u8 and bf16 rates
    at the prefilter's operand shapes (2,048 lanes x depth 128 x 262,144
    positions) as a share of the card's peak; P7, the lookup kernel the
    tensor-core prefilter replaced, at database group 0; P8 and P10, the
    tensor-core instantiations in each orientation at the bench shape
    (and at group 0);
21. the scoring probes (``lightmotif_tpu_torch.probes.scoring``) and P9,
    each checked once against its plain version with its launches counted
    from 0, then timed: family A, every instantiation of the scoring
    kernel in each mode it takes at the genome (the first kernel, variant 0,
    among them);
    family B, the diagnostic bodies (io only, floor, nosel, noroll, add,
    K2 writing uint8); family C, the op chains over 4,718,592 bytes; P13's
    host parity (the pairwise association changes windows, the prefix
    forms none); P9, the per-lane pass bits beside K3 at database group 0;
22. with ``--parent DIR`` (another checkout, e.g. a ``git archive`` of the
    parent commit): the parent's prefilter, phase C and pairs libraries
    built from DIR's sources, their tensor-core (``IMMA``) counts equal
    to this tree's, the pairs library's ``FADD`` and ``FFMA`` counts
    equal, the ``ptxas -v`` lines of both; then the steady walls of both
    checkouts, each in processes of its own, in turns (parent, change,
    change, parent): the database's ``scan_arrays`` on one card, its
    ``ShardedMultiScanner`` on 8 shards of one card and on 1..N cards;
    MX000001's resident ``Scanner.collect()`` on the genome and on the
    chromosome, ``BatchScanner.collect`` and ``ShardedScanner.collect`` on
    8 shards and on 1..N cards;
23. the database scan at chromosome scale (``[scale]``): the 50 Mbp
    genome of ``bench_biggenome`` (seed 0xB16) and a seeded stand-in of
    the 248,956,422 bp GRCh38 chromosome 1 (N runs of 10,000 at each end
    and 18,000,000 near the middle, over whole segments), each through
    ``MultiScanner.scan_arrays`` against the per-PSSM K1 brute force: the
    first scan's wall, re-runs and memory, K3, phase C and the pairs
    kernel once per (group, segment) and per re-run, one read per steady
    ``collect_arrays`` and none in its dispatch (sync debug mode "error"),
    the steady walls (median, p90) and one profiled steady run (busy, idle
    share, host, top kernels); ``ShardedMultiScanner`` on 8 shards of the
    card and, with two or more cards, on 1..N cards, equal to one card,
    one read a call, walls in turns and each card's split; on the
    chromosome, ``Pipeline.score_max`` against K1 plus a host scan of the
    last maximum and ``Scanner.collect()`` at p = 1e-5 against K1 +
    threshold + ``nonzero`` (the segment kernel once per segment and re-run, one
    read a steady call, one profiled steady run); the CLI on the 50 Mbp genome as one FASTA
    record (both strands, p = 1e-6), its rows equal to ``scan_arrays``,
    with its split (read and encode, motif preparation, first scan, the
    rest per hit); then what the CUDA graphs keep beside one eager scan's
    peak on 2 segments and on all of each genome, with the same bounds as
    phase 8.  ``--scale-only`` adds the sweeps: ``MultiScanner`` on the 50
    Mbp genome at 2**22-2**25 window starts a segment (first scan,
    re-runs, walls, idle share, eager peak, what the graphs keep, the
    bacterial genome at the same segment) and the Scanner on the
    chromosome at 2**22-2**26 and 2**28.

The line before the last is a JSON object with one entry per kernel
(launches counted on the path that runs it, with the counts reset just
before it; for a probe, in its own check); the last line is ``{"ok":
true, "device": {...}}``.  There is no CPU path: without a CUDA device
the script fails.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

ECOLI_LENGTH = 4_641_652
PATTERNS = ["GTTGACCTTATCAAC", "GTTGATCCAGTCAAC"]  # == MX000001 counts
KNOWN_BEST_POS = 3_254_602
KNOWN_BEST_BITS = 0x4197E448  # f32 18.986465...
KNOWN_TIE_POS = 2_558_379  # scores the identical f32 value
RUNS = 15
DEVICE = torch.device("cuda")

SOURCE = "lightmotif_tpu_torch/ops/csrc/score.cu"
REPLACES = "lightmotif_tpu/ops/kernels.py:73"
K3_SOURCE = "lightmotif_tpu_torch/ops/csrc/prefilter.cu"
K3_REPLACES = "lightmotif_tpu/ops/multi_kernel.py:300"
K4_REPLACES = "lightmotif_tpu/ops/multi_kernel.py:163"
K5_REPLACES = "lightmotif_tpu/ops/multi_kernel.py:213"
# the database scan's exact stages: XLA code of the JAX scan_multi_core (no
# Pallas kernel there), phase C and the pairs / rescore / keep that follow
PHASE_C_SOURCE = "lightmotif_tpu_torch/ops/csrc/phase_c.cu"
PHASE_C_REPLACES = "lightmotif_tpu/ops/multi.py:868"
PAIRS_SOURCE = "lightmotif_tpu_torch/ops/csrc/pairs.cu"
PAIRS_REPLACES = "lightmotif_tpu/ops/multi.py:975"
# the Scanner's segment in one launch: XLA code of the JAX scan_segment (its
# discrete pass through K2's Pallas kernel, threshold_positions,
# rescore_positions, the front compaction)
SEGMENT_SOURCE = "lightmotif_tpu_torch/ops/csrc/scan.cu"
SEGMENT_REPLACES = "lightmotif_tpu/ops/xla_ops.py:291"
PROBE_SOURCE = "lightmotif_tpu_torch/ops/csrc/probes.cu"
P6_REPLACES = "experiments/int8_probe.py:54"
P7_REPLACES = "experiments/int8_probe2.py:98"
P8_REPLACES = "experiments/multi_opt.py:106"
P10_REPLACES = "experiments/multi_opt2.py:95"
P9_REPLACES = "experiments/multi_opt.py:193"

#: P6's positions: 256 tiles of 1,024 (the JAX probe's tile)
P6_POSITIONS = 1024 * 256

DB_MOTIFS = 2346  # JASPAR2024 CORE, as tests/test_io.py pins it
DB_SEED = 0x1A5BA2
DB_PVALUE = 1e-6
PROTEIN_LENGTH = 1_000_000
PROTEIN_MOTIFS = 200
PROTEIN_PVALUE = 1e-5

# K4 at the shape of bench.py:123-130: 1,024 lanes of m = 15 random u8
# cells (0-199, zero wildcard column), thresholds 2,400 written by hand
BENCH_K4_LANES = 1024
BENCH_K4_M = 15
BENCH_K4_THRESHOLD = 2400

#: Lanes per u8 (K4) mode group: the u8 candidate union saturates larger
#: groups (lightmotif_tpu/ops/multi.py:837-840).
K4_GROUP_LANES = 512

# batched records: the genome cut into seeded records of 50-2,000 bp,
# every RECORD_SHORT_EVERY-th one shorter than the motif
RECORD_SEED = 0xBA7C4
RECORD_LENGTHS = (50, 2000)
RECORD_SHORT_EVERY = 97

# the CLI phase: the TSV's header, and the flight size of its several-flight
# run (the records file is about 4.8 MB)
CLI_HEADER = "seq_index\tseq_name\tmotif_index\tmotif_name\tpos\tstrand\tscore\tpvalue"
CLI_FLIGHT_BYTES = 1 << 20

# the host Gibbs sampler: SAMPLER_COUNT sequences of each length, MX000001's
# first site planted once in each, SAMPLER_STEPS OOPS steps
SAMPLER_SEED = 0x5A3D1
SAMPLER_COUNT = 16
SAMPLER_LONG = 40_000
SAMPLER_SHORT = 500
SAMPLER_STEPS = 200

# the batched sampler: BATCH_SEQS peak-like sequences of 100-500 bp with a
# width-10 site planted once in each, BATCH_CHAINS chains.  BATCH_STEPS
# (one step per sequence) is the resumed run; recovering the site takes
# about six sweeps of the 200 sequences (BATCH_RECOVERY_STEPS)
BATCH_SEED = 0xB5A
BATCH_SEQS = 200
BATCH_LENGTHS = (100, 500)
BATCH_MOTIF = "TGACTCAGCA"
BATCH_CHAINS = 64
BATCH_STEPS = 200
BATCH_RECOVERY_STEPS = 1200
BATCH_ZOOPS_SEEDS = 4

# the sharded scans: shards on the one card
MESH_SHARDS = 8

# the database scan at chromosome scale: bench_biggenome's 50 Mbp genome
# (benchmarks/run.py:679-720) and a seeded stand-in of the length of GRCh38
# chromosome 1, uniform ACGT with N runs where a chromosome has gaps: at
# each end, and one of CHROM_GAP (start, length) near the middle that covers
# whole segments
SCALE_GENOME_LENGTH = 50_000_000
SCALE_GENOME_SEED = 0xB16
CHROM_LENGTH = 248_956_422
CHROM_SEED = 0xC4201
CHROM_END_N = 10_000
CHROM_GAP = (117_000_000, 18_000_000)
#: steady walls per scale measurement (a chromosome scan takes ~1 s)
SCALE_RUNS = 7
#: window starts per segment that --scale-only's sweep compares
SCALE_SEGMENTS = (1 << 22, 1 << 23, 1 << 24, 1 << 25)

# the card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W),
# for the least time a kernel's work could take
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"f32": 67e12, "int8": 1979e12}


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def f32_bits(x) -> int:
    return int(np.float32(x).view(np.uint32))


def build_inputs():
    from lightmotif_tpu_torch import CountMatrix, EncodedSequence

    cm = CountMatrix.from_sequences(EncodedSequence.encode(p) for p in PATTERNS)
    pssm = cm.to_freq(0.1).to_weight(None).to_scoring()
    rng = np.random.default_rng(0xECC011)
    genome = rng.integers(0, 4, size=ECOLI_LENGTH, dtype=np.int8)
    return pssm, EncodedSequence(genome.astype(np.uint8))


def max_abs_err(got, want) -> float:
    """Largest |got - want|, counting equal entries (``-inf`` included)
    as 0."""
    diff = (got.double() - want.double()).abs()
    return float(torch.where(got == want, 0.0, diff).max()) if got.numel() else 0.0


def reset_launches() -> None:
    """Every kernel wrapper's launch count, and the database scan's re-runs
    at larger capacities, to 0."""
    from lightmotif_tpu_torch.ops import kernels, multi, multi_kernel, multi_stages

    kernels.reset_launches()
    multi_kernel.reset_launches()
    multi_stages.reset_launches()
    multi.reset_reruns()


def launch_counts() -> dict:
    """The launches of every kernel wrapper since the last reset."""
    from lightmotif_tpu_torch.ops import kernels, multi_kernel, multi_stages

    return {**kernels.LAUNCHES, **multi_kernel.LAUNCHES, **multi_stages.LAUNCHES}


def group_launches(n: int, prefilter: str = "prefilter_any8") -> dict:
    """The launches of ``n`` motif-group segments of the database scan and
    of its re-runs since the last reset: the prefilter, phase C and the
    pairs wrapper once each (its two kernels)."""
    from lightmotif_tpu_torch.ops import multi, multi_stages

    n += multi.RERUNS["group"]
    return {prefilter: n, "phase_c_bits": n, "pairs_rescore": n * multi_stages.PAIRS_KERNELS}


def phase_card() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    log("card", torch=torch.__version__, cuda=torch.version.cuda,
        device=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count())


def phase_build() -> None:
    """The production build (``score.cu``, ``prefilter.cu``: what a scan
    waits for), then the probe build (``probes.cu`` added), each with its
    own nvcc seconds."""
    from lightmotif_tpu_torch.ops import build

    for what, probes, load in (("production", False, build.library),
                               ("probes", True, build.probe_library)):
        t0 = time.perf_counter()
        info = build.build_info(probes)
        load()
        log("build", build=what, directory=build.build_dir(),
            seconds=f"{time.perf_counter() - t0:.3f}",
            nvcc_seconds=f"{info['seconds']:.3f}",
            compiled=",".join(p.name for p in info["compiled"]) or "none",
            libraries=",".join(p.name for p in info["paths"]))
    for line in info["log"].splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)
    # fresh builds in subprocesses, each into an empty build directory:
    # every source at once (what a scan waited for before the split), then
    # the production sources alone
    for what, probes in (("whole", True), ("production", False)):
        log("build", fresh=what, nvcc_seconds=f"{fresh_build_seconds(probes):.3f}")


def fresh_build_seconds(probes: bool) -> float:
    """nvcc seconds of ``build.build_info(probes)`` in a new process with
    an empty build directory."""
    import os
    import shutil
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    cache = tempfile.mkdtemp(prefix="chip-smoke-build-")
    try:
        proc = subprocess.run(
            [sys.executable, "-c", "from lightmotif_tpu_torch.ops import build; "
             f"print(build.build_info(probes={probes})['seconds'])"],
            cwd=root, capture_output=True, text=True, timeout=600,
            env=dict(os.environ, LIGHTMOTIF_TPU_COMPILE_CACHE=cache,
                     PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", "")))
        if proc.returncode != 0:
            raise SystemExit(f"build: fresh build failed\n{proc.stderr[-4000:]}")
        return float(proc.stdout.split()[-1])
    finally:
        shutil.rmtree(cache, ignore_errors=True)


def sass_opcodes(path) -> dict:
    """The opcodes (``FADD``, ``IMMA``, ...; modifiers dropped) of each
    kernel in a built library's SASS (``cuobjdump -sass``), by mangled
    name."""
    import os
    import re
    import shutil

    tool = shutil.which("cuobjdump") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True, text=True,
                          check=True).stdout
    ops, name = {}, None
    instr = re.compile(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9]*)")
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            ops[name] = []
        elif name and (hit := instr.search(line)):
            ops[name].append(hit.group(1))
    return ops


def sass_mma_counts(path) -> dict:
    """Tensor-core instructions (``IMMA``, ``HMMA``, ``HGMMA``, ``IGMMA``) of
    each kernel in a built library, by mangled name."""
    return {name: sum(op in ("IMMA", "HMMA", "HGMMA", "IGMMA") for op in ops)
            for name, ops in sass_opcodes(path).items()}


def score_mangled(variant: int, discrete: bool) -> str:
    """The mangled-name part of a scoring instantiation's template
    arguments (``score_kernel<DISCRETE, LK, P, NT, TP, HALO, LAZY, PERSIST,
    MINB, KC, G>`` in ``score.cu``)."""
    from lightmotif_tpu_torch.probes import scoring

    lookup, p, nt, tp, halo, lazy, persist, minb, kc, grp = scoring.VARIANTS[variant]
    lk = scoring._LOOKUPS.index(lookup)
    return (f"score_kernelILb{int(discrete)}ELi{lk}ELi{p}ELi{nt}ELi{tp}"
            f"ELi{scoring._HALOS.index(halo)}ELb{lazy}ELi{persist}ELi{minb}ELi{kc}"
            f"ELi{grp}EE")


def scan_sass() -> None:
    """The segment kernel's two forms (``scan.cu``: the ``__byte_perm``
    and the generic lookup) rescore with ``FADD`` and the library has no
    ``FFMA``; their instruction counts and ``ptxas -v`` lines."""
    from lightmotif_tpu_torch.ops import build

    lib = next(p for p in build.build_info()["paths"] if p.name.startswith("liblm-scan-"))
    ops = sass_opcodes(lib)
    forms = {n: o for n, o in ops.items() if "scan_kernel" in n}
    n_fadd = {n: o.count("FADD") for n, o in forms.items()}
    n_ffma = sum(o.count("FFMA") for o in ops.values())
    if len(forms) != 2 or min(n_fadd.values()) < 1 or n_ffma:
        raise SystemExit(f"sass: the scan library's kernels {list(forms)}: FADD {n_fadd}, "
                         f"{n_ffma} FFMA")
    log("sass", library=lib.name, functions=len(ops), fadd=sum(n_fadd.values()), ffma=n_ffma,
        prmt=sum(o.count("PRMT") for o in forms.values()),
        instructions=sum(len(o) for o in forms.values()),
        ptxas=" | ".join(ptxas_lines(build.build_info()["log"], ("scan_kernel",))))


def phase_sass() -> int:
    """The prefilter library's SASS: every tensor-core instantiation, the
    production one and P9's bits form included, must hold tensor-core
    instructions; the lookup kernel (P7's baseline) holds none.  Phase C's
    kernel holds IMMA too; the pairs library and both forms of the segment
    kernel add with FADD, never FFMA;
    both with their ``ptxas -v`` registers and spills.  The scoring
    library's: K1's production instantiation adds with FADD and never with
    FFMA (no contraction), K2's looks up with PRMT.  Returns the
    production prefilter's IMMA count."""
    from lightmotif_tpu_torch.ops import build
    from lightmotif_tpu_torch.probes import prefilter as probes

    import re

    lib = next(p for p in build.build_info()["paths"] if "prefilter" in p.name)
    counts = sass_mma_counts(lib)
    # mma_kernel<POS_M, CPP, PW, NW, BITS>, by its template arguments
    form = re.compile(r"mma_kernelILb(\d)ELi(\d+)ELi(\d+)ELi(\d+)ELb(\d)EE")
    mma = {tuple(int(x) for x in hit.groups()): c for n, c in counts.items()
           if (hit := form.search(n))}
    v = build.library().lm_prefilter_production()
    orient, cpp, pw, warps = probes.VARIANTS[v]
    production = mma.get((int(orient == "m"), cpp, pw, warps, 0), 0)
    per_variant = {f"{'m' if a[0] else 'n'}{a[1]}x{a[2]}x{a[3]}": c
                   for a, c in mma.items() if a[4] == 0}
    bits = [c for a, c in mma.items() if a[4] == 1]
    lookup = sum(c for n, c in counts.items() if "lookup_kernel" in n)
    if (production < 1 or len(bits) != 1 or bits[0] < 1
            or len(per_variant) != len(probes.VARIANTS) or min(per_variant.values()) < 1):
        raise SystemExit(f"sass: a tensor-core instantiation without IMMA: {counts}")
    log("sass", library=lib.name, tool="cuobjdump -sass",
        production=f"variant {v} {probes.VARIANTS[v]}", production_imma=production,
        p9_bits_imma=bits[0], total_tensor_core=sum(counts.values()),
        lookup_kernel=lookup, per_instantiation=per_variant)

    # phase C on the tensor cores
    log_text = build.build_info()["log"]
    lib = next(p for p in build.build_info()["paths"] if "phase_c" in p.name)
    ops = sass_opcodes(lib)
    imma = {n: sum(op == "IMMA" for op in o) for n, o in ops.items() if "phase_c_kernel" in n}
    if len(imma) != 1 or min(imma.values()) < 1:
        raise SystemExit(f"sass: phase C's kernel without IMMA: {imma}")
    log("sass", library=lib.name, phase_c_imma=min(imma.values()),
        instructions=sum(len(o) for o in ops.values()),
        ptxas=" | ".join(ptxas_lines(log_text, ("phase_c_kernel",))))

    # the pairs kernel's rescore adds with FADD, never FFMA; no kernel of the
    # library contracts
    lib = next(p for p in build.build_info()["paths"] if "pairs" in p.name)
    ops = sass_opcodes(lib)
    n_fadd = sum(o.count("FADD") for o in ops.values())
    n_ffma = sum(o.count("FFMA") for o in ops.values())
    if not any("keep_pairs" in n for n in ops) or n_fadd < 1 or n_ffma:
        raise SystemExit(f"sass: the pairs library has {n_fadd} FADD and {n_ffma} FFMA")
    log("sass", library=lib.name, functions=len(ops), fadd=n_fadd, ffma=n_ffma,
        keep_pairs_fadd=sum(o.count("FADD") for n, o in ops.items() if "keep_pairs" in n),
        ptxas=" | ".join(ptxas_lines(log_text, ("row_offsets", "keep_pairs"))))

    scan_sass()

    lib = next(p for p in build.build_info()["paths"] if "score" in p.name)
    ops = sass_opcodes(lib)
    found = {}
    for discrete in (False, True):
        v_prod = build.probe_library().lm_score_production(int(discrete))
        names = [n for n in ops if score_mangled(v_prod, discrete) in n]
        if len(names) != 1:
            raise SystemExit(f"sass: production scoring instantiation {v_prod} not found")
        found[discrete] = (v_prod, ops[names[0]])
    v_f32, f32_ops = found[False]
    v_u8, u8_ops = found[True]
    n_fadd, n_ffma = f32_ops.count("FADD"), f32_ops.count("FFMA")
    if n_fadd < 1 or n_ffma != 0:
        raise SystemExit(f"sass: lm_score_f32's kernel has {n_fadd} FADD and {n_ffma} FFMA")
    if u8_ops.count("PRMT") < 1:
        raise SystemExit("sass: lm_score_u8's kernel has no PRMT")
    log("sass", library=lib.name, score_f32=f"variant {v_f32}", fadd=n_fadd, ffma=n_ffma,
        lds=f32_ops.count("LDS"), instructions=len(f32_ops),
        score_u8=f"variant {v_u8}", prmt=u8_ops.count("PRMT"), u8_lds=u8_ops.count("LDS"),
        u8_instructions=len(u8_ops))
    return production


def check_kernel(name, wrapper, plain, seq, table, n_scores) -> float:
    got = wrapper(seq, table, n_scores)
    want = plain(seq, table, n_scores)
    torch.cuda.synchronize()
    if not torch.equal(got, want):
        bad = int(torch.nonzero(got != want)[0])
        raise SystemExit(
            f"{name}: kernel != plain at {bad} (m={table.shape[0]}, "
            f"k={table.shape[1]}, n={seq.shape[0]}, n_scores={n_scores}): "
            f"{got[bad].item()} vs {want[bad].item()}")
    return max_abs_err(got, want)


def phase_kernels(pssm, seq) -> dict:
    """K1 and K2 against the plain versions; returns the largest error
    of each kernel over every case."""
    from lightmotif_tpu_torch.ops import kernels, torch_ops
    from lightmotif_tpu_torch.ops.pipeline import DeviceSequence

    rng = np.random.default_rng(0x5EED)
    errs = {"score_f32": 0.0, "score_u8": 0.0}
    # DNA through the production instantiations (k = 5 fixed) and, past m =
    # 257 for K2, the generic one; protein, k = 7 and k = 256 through the
    # generic one
    cases = [(5, 1), (5, 15), (5, 33), (5, 129), (5, 300), (21, 10), (21, 40), (7, 12),
             (256, 3)]
    for k, m in cases:
        length = int(rng.integers(50_000, 120_000))
        s = rng.integers(0, min(k + 2, 256), size=length).astype(np.uint8)  # ranks >= k too
        for start in rng.integers(0, length - 300, size=20):  # wildcard runs
            s[start : start + int(rng.integers(1, 300))] = k - 1
        w = rng.normal(size=(m, k)).astype(np.float32)
        w[rng.random((m, k)) < 0.05] = -np.inf
        d = rng.integers(0, 256, size=(m, k)).astype(np.uint8)
        n_scores = max(length - m + 1 - int(rng.integers(0, 5000)), 0)
        sd = torch.from_numpy(s).to(DEVICE)
        errs["score_f32"] = max(errs["score_f32"], check_kernel(
            "score_f32", kernels.score_f32, torch_ops.score_f32, sd,
            torch.from_numpy(w).to(DEVICE), n_scores))
        errs["score_u8"] = max(errs["score_u8"], check_kernel(
            "score_u8", kernels.score_u8, torch_ops.score_u8, sd,
            torch.from_numpy(d).to(DEVICE), n_scores))
        log("kernels", k=k, m=m, length=length, n_scores=n_scores, equal=True)

    # the shapes of the main path: the padded genome, and the Scanner's
    # one-segment chunk
    dseq = DeviceSequence(seq, DEVICE)
    m = len(pssm)
    n = len(seq) - m + 1
    w = torch.from_numpy(pssm.data).to(DEVICE)
    d = torch.from_numpy(pssm.to_discrete().data).to(DEVICE)
    errs["score_f32"] = max(errs["score_f32"], check_kernel(
        "score_f32", kernels.score_f32, torch_ops.score_f32, dseq.data, w, n))
    errs["score_u8"] = max(errs["score_u8"], check_kernel(
        "score_u8", kernels.score_u8, torch_ops.score_u8,
        dseq.data[: n + m - 1], d, n))
    log("kernels", shape="genome", length=dseq.data.shape[0], n_scores=n,
        equal=True, max_abs_err=errs)
    return errs


#: The segment kernel's cases beside the card tests' (``tests/torch_segments.py``,
#: which makes each case's inputs): (k, m, length, highest rank + 1,
#: threshold kind, capacity kind), the longer ones here.
SEGMENT_CASES = [(5, 15, 400_003, 4, "dense", "below"), (5, 15, 400_003, 4, "dense", "at"),
                 (5, 15, 400_003, 4, "sparse", "above"), (5, 12, 200_001, 6, "neginf", "above"),
                 (21, 10, 150_000, 21, "dense", "above"), (21, 40, 100_000, 23, "sparse", "below"),
                 (7, 7, 4_097, 9, "dense", "below"), (256, 3, 60_000, 256, "dense", "at"),
                 (256, 5, 30_000, 256, "neginf", "below"), (5, 6, 50_000, 5, "zeros", "above"),
                 (5, 15, 15, 4, "neginf", "above"), (5, 1, 10_000, 5, "dense", "above"),
                 (5, 300, 20_000, 4, "dense", "below"), (5, 15, 30_001, 4, "none", "above"),
                 (5, 15, 30_001, 4, "dense", "one"), (5, 15, 30_001, 4, "dense", "tile_first"),
                 (5, 15, 30_001, 4, "dense", "tile_second"),
                 (5, 15, 30_001, 4, "dense", "tile_inside"),
                 (5, 15, 200_001, 4, "sparse", "tile_first")]


def check_scan_segment(what, chunk, n, dm, table, t_scaled, threshold, cap) -> dict:
    """The segment kernel against its plain version on the card
    (``torch.equal``): the counters, the kept hits (positions and f32 bits,
    as int32; the slots the contract defines) and the best of them.
    Returns the case's counts."""
    from lightmotif_tpu_torch.ops import kernels, torch_ops

    got = kernels.scan_segment(chunk, n, dm, table, t_scaled, threshold, cap)
    want = torch_ops.scan_segment(chunk, n, dm, table, t_scaled, threshold, cap)
    torch.cuda.synchronize()
    counts, packed, best = got
    if not torch.equal(counts, want[0]):
        raise SystemExit(f"scan_segment {what}: counters {counts.tolist()} != plain "
                         f"{want[0].tolist()}")
    n_kept = int(want[0][1])
    if not torch.equal(packed[:, :n_kept], want[1][:, :n_kept]):
        bad = int(torch.nonzero((packed[:, :n_kept] != want[1][:, :n_kept]).any(0))[0])
        raise SystemExit(f"scan_segment {what}: kept hit {bad} {packed[:, bad].tolist()} != "
                         f"plain {want[1][:, bad].tolist()}")
    if not torch.equal(best, want[2]):
        raise SystemExit(f"scan_segment {what}: best {best.tolist()} != plain "
                         f"{want[2].tolist()}")
    return {"count": int(want[0][0]), "n_kept": n_kept, "cap": cap, "best": best.tolist()}


def phase_scan_segment(pssm, seq) -> float:
    """The segment kernel (``kernels.scan_segment``) against its plain
    version on DNA, protein, k = 7 and k = 256 tables (ranks >= K and
    wildcard runs), m = 1 and m = 300, ragged lengths, no candidate,
    capacities of 1, below, at and above the candidate count and on and
    inside a tile's candidates, threshold -inf, exact zero sums (+0.0
    bits), then at the main path's shape -- the genome's one segment at p
    = 1e-5, and at a threshold of ~46,000 candidates whose kept hits
    outgrow a Scanner's first head.  Returns the largest difference (0.0:
    every case equal)."""
    from lightmotif_tpu_torch.ops.multi import HEAD_SLOTS
    from lightmotif_tpu_torch.scanner import DEFAULT_CAPACITY
    from tests.torch_segments import segment_inputs

    for i, (k, m, length, ranks, kind, cap_kind) in enumerate(SEGMENT_CASES):
        s, d, w, n, t_scaled, threshold, cap, _ = segment_inputs(k, m, length, ranks, kind,
                                                                 cap_kind, seed=0xC3 + i)
        sd, wd, dd = (torch.from_numpy(a).to(DEVICE) for a in (s, w, d))
        got = check_scan_segment(f"k={k} m={m} {cap_kind}", sd, n, dd, wd, t_scaled, threshold,
                                 cap)
        if (kind == "zeros" and not got["n_kept"]) or (kind == "none" and got["count"]):
            raise SystemExit(f"scan_segment k={k} m={m}: a {kind} case keeps "
                             f"{got['n_kept']} of {got['count']}")
        log("scan_segment", k=k, m=m, length=length, threshold=threshold, cap_kind=cap_kind,
            equal=True, **got)
    m = len(pssm)
    n = len(seq) - m + 1
    chunk = torch.from_numpy(np.ascontiguousarray(seq.data, np.uint8)).to(DEVICE)
    w = torch.from_numpy(np.ascontiguousarray(pssm.data, np.float32)).to(DEVICE)
    dm = pssm.to_discrete()
    d = torch.from_numpy(np.ascontiguousarray(dm.data, np.uint8)).to(DEVICE)
    for what, t in (("p=1e-5", pssm.score_distribution().score(1e-5)),
                    ("p=1e-2", pssm.score_distribution().score(1e-2))):
        got = check_scan_segment(f"genome {what}", chunk, n, d, w, dm.scale(t), t,
                                 DEFAULT_CAPACITY)
        log("scan_segment", shape=f"genome, one segment, {what}", equal=True,
            head_slots=HEAD_SLOTS, **got)
        if what == "p=1e-2" and got["n_kept"] <= HEAD_SLOTS:
            raise SystemExit(f"scan_segment: the p=1e-2 case keeps {got['n_kept']} hits only")
    return 0.0


def phase_main_path(pssm, seq) -> tuple:
    """The main path on the genome; returns its launches and the
    Scanner's hits at p = 1e-5 (positions, f32 bits)."""
    from lightmotif_tpu_torch import Scanner
    from lightmotif_tpu_torch.ops import kernels
    from lightmotif_tpu_torch.ops.pipeline import Pipeline
    from lightmotif_tpu_torch.scanner import DEFAULT_CAPACITY, DEFAULT_SEGMENT

    host = pssm.score_host(seq)
    n = host.shape[0]
    t = pssm.score_distribution().score(1e-5)
    want_pos = np.nonzero(host >= np.float32(t))[0]
    want_bits = host[want_pos].view(np.uint32)

    reset_launches()
    scores = pssm.score(seq).unstripe().data
    if not (scores.shape == host.shape and np.array_equal(scores, host)):
        raise SystemExit("pssm.score != score_host over the genome")
    log("main", check="full-genome bit parity", windows=n)

    mx, am = Pipeline(DEVICE).score_max(pssm, seq)
    if (am != KNOWN_BEST_POS or f32_bits(mx) != KNOWN_BEST_BITS
            or f32_bits(host[KNOWN_TIE_POS]) != KNOWN_BEST_BITS):
        raise SystemExit(f"score_max known answer failed: ({mx}, {am})")
    log("main", check="score_max", argmax=am, bits=hex(f32_bits(mx)),
        tie_at=KNOWN_TIE_POS)

    # the discrete scores (the reference's u8 scoring): K2 once
    dm = pssm.to_discrete()
    before = kernels.LAUNCHES["score_u8"]
    discrete = Pipeline(DEVICE).score_discrete(dm, seq).unstripe().data
    ranks = np.asarray(seq.data, np.int64)
    table = np.asarray(dm.data, np.int64)
    want_u8 = np.zeros(n, np.int64)
    for j in range(len(pssm)):
        want_u8 += table[j][ranks[j : j + n]]
    if not np.array_equal(discrete, np.minimum(want_u8, 255)) or \
            kernels.LAUNCHES["score_u8"] - before != 1:
        raise SystemExit("Pipeline.score_discrete != the host's clamped sums (or K2 not once)")
    log("main", check="Pipeline.score_discrete == the host's clamped u8 sums; K2 once",
        windows=n, candidates_at_p1e5=int((discrete >= dm.scale(t)).sum()))

    def one_pssm(scanner, what, fn, segments):
        """``fn`` of ``scanner`` (the same hits as the brute force for a
        collect, the known best for a max), launching the segment kernel
        once per segment and once per re-run, and K2 never."""
        before = {k: kernels.LAUNCHES[k] for k in ("score_u8", "scan_segment")}
        reruns = scanner.reruns
        got = fn()
        launched = {k: kernels.LAUNCHES[k] - v for k, v in before.items()}
        want = segments + scanner.reruns - reruns
        if launched != {"score_u8": 0, "scan_segment": want}:
            raise SystemExit(f"{what}: launches {launched}, {segments} segments and "
                             f"{scanner.reruns - reruns} re-runs")
        if fn == scanner.max:
            if got.position != KNOWN_BEST_POS or f32_bits(got.score) != KNOWN_BEST_BITS:
                raise SystemExit(f"{what} failed: {got}")
            return got
        pos = np.array([h.position for h in got], dtype=np.int64)
        bits = np.array([f32_bits(h.score) for h in got], dtype=np.uint32)
        if not (np.array_equal(pos, want_pos) and np.array_equal(bits, want_bits)):
            raise SystemExit(f"{what} != brute force: {len(got)} hits vs {len(want_pos)}")
        return got

    for block_size, capacity in ((DEFAULT_SEGMENT, DEFAULT_CAPACITY), (n // 4, DEFAULT_CAPACITY),
                                 (DEFAULT_SEGMENT, 4)):
        scanner = Scanner(pssm, seq, threshold=t, block_size=block_size, capacity=capacity)
        segments = -(-n // block_size)
        hits = one_pssm(scanner, f"Scanner.collect (block_size {block_size}, capacity "
                        f"{capacity})", scanner.collect, segments)
        first = (scanner.host_reads, scanner.reruns, scanner.capacity)
        if capacity == 4 and not (scanner.capacity > 4 and scanner.reruns == segments):
            raise SystemExit(f"Scanner at capacity 4 did not ratchet: {first}")
        # a steady collect and max read the card once and run nothing again
        scanner.host_reads = 0
        one_pssm(scanner, "a steady Scanner.collect", scanner.collect, segments)
        best = one_pssm(scanner, "Scanner.max", scanner.max, segments)
        if scanner.host_reads != 2 or scanner.reruns != first[1]:
            raise SystemExit(f"Scanner: a steady collect and max read the card "
                             f"{scanner.host_reads} times, {scanner.reruns} re-runs")
        # the issue reads nothing (sync debug mode "error")
        torch.cuda.synchronize()
        try:
            torch.cuda.set_sync_debug_mode("error")
            issued = scanner._issue(scanner._runs(int(scanner.dm.scale(t)), t))
        except RuntimeError as e:
            raise SystemExit(f"Scanner: the issue read the card: {e}") from None
        finally:
            torch.cuda.set_sync_debug_mode("default")
        if len(issued) != segments:
            raise SystemExit(f"Scanner: {len(issued)} segments issued, {segments} expected")
        log("main", check="Scanner.collect == brute force; a steady collect and max read the "
            "card once each, the issue never (sync debug mode error); the segment kernel once a "
            "segment and a re-run, K2 never", threshold=t, hits=len(hits), segments=segments,
            capacity=capacity, first_reads=first[0], reruns=first[1], capacity_after=scanner.capacity,
            steady_reads=1, best=best.position, best_bits=hex(f32_bits(best.score)),
            tie_at=KNOWN_TIE_POS)

    launches = dict(kernels.LAUNCHES)
    if min(launches.values()) < 1:
        raise SystemExit(f"a kernel of the main path never launched: {launches}")
    log("main", launches=launches)
    return launches, (want_pos, want_bits)


def synthetic_counts(rng, alphabet, lengths, sites: int = 20):
    """Count matrices of ``sites`` aligned sites each: every column's
    symbol probabilities are drawn from Dirichlet(0.5) and its counts
    from them; the wildcard column is zero."""
    from lightmotif_tpu_torch import CountMatrix

    k = len(alphabet.symbols)
    out = []
    for m in lengths:
        probs = rng.dirichlet(np.full(k - 1, 0.5), size=int(m))
        counts = np.zeros((int(m), k), np.int64)
        counts[:, : k - 1] = [rng.multinomial(sites, row) for row in probs]
        out.append(CountMatrix(alphabet, counts))
    return out


def synthetic_motifs(rng, alphabet, lengths, sites: int = 20):
    """The scoring matrices of :func:`synthetic_counts`: pseudocount 0.1,
    uniform background."""
    return [c.to_freq(0.1).to_weight(None).to_scoring()
            for c in synthetic_counts(rng, alphabet, lengths, sites)]


def synthetic_database(n: int, seed: int):
    """A JASPAR2024-sized DNA database on both strands: (pssms, thresholds
    at DB_PVALUE, the forward strands' count matrices).  Lengths 5-20 for
    about 92% of the motifs, 21-35 for the rest."""
    from lightmotif_tpu_torch import DNA

    rng = np.random.default_rng(seed)
    lengths = np.where(rng.random(n) < 0.92, rng.integers(5, 21, n),
                       rng.integers(21, 36, n))
    counts = synthetic_counts(rng, DNA, lengths)
    fwd = [c.to_freq(0.1).to_weight(None).to_scoring() for c in counts]
    ths = [p.score_distribution().score(DB_PVALUE) for p in fwd]
    return (fwd + [p.reverse_complement() for p in fwd],
            np.asarray(ths + ths, np.float32), counts)


def k3_group(pssms, thresholds):
    """The K3 inputs of one motif group, on the card, its m_max and ragged
    widths, and the K4 and K5 tables of the same motifs: K5 from the JAX
    layout of the u16 filters, K4 from the u8 discrete matrices."""
    from lightmotif_tpu_torch.ops import multi, multi_kernel

    k = pssms[0].alphabet.size
    stack, lengths = multi.stack_motifs([p.data for p in pssms], k)
    m_max = int(lengths.max())
    ths = np.asarray(thresholds, np.float32)
    g = multi.pack_motif_group(np.arange(len(pssms)), len(pssms), m_max, stack, ths, k)
    k5 = multi.group_from_filters(g["pssm"], g["th"], m_max, k, DEVICE,
                                  filters_fine=(g["f_hi"], g["f_lo"]),
                                  widths=g["widths"])["k5"]
    dms = [p.to_discrete() for p in pssms]
    dm_stack, _ = multi.stack_motifs([d.data.astype(np.float32) for d in dms], k)
    t_scaled = np.asarray([d.scale(t) for d, t in zip(dms, ths)], np.int64)
    t_scaled[ths > 1e5] = 300  # never-pass lanes: past the u8 range
    k4 = [torch.from_numpy(a).to(DEVICE) for a in multi.pack_filters_k4(
        multi_kernel.pack_filters_any(dm_stack, t_scaled, k), k)]
    return ([torch.from_numpy(a).to(DEVICE) for a in g["k3"]], m_max, g["widths"],
            {"prefilter_any": k4, "prefilter_any16": list(k5)})


def prefilter_cases():
    """The prefilter checks' groups and sequences (seed 0xA11): DNA groups
    of 16, 256 (ragged) and 2,048 lanes with m_max 2 to 128, protein
    groups with m_max 5 and 32, every 7th lane never passing, sequences
    with wildcard runs.  Yields (k, lengths, k3_group(...), sequence)."""
    from lightmotif_tpu_torch import DNA, PROTEIN

    rng = np.random.default_rng(0xA11)
    ragged = lambda top: sorted(  # noqa: E731
        [int(w) for w in rng.integers(5, 15, 240)]
        + [int(w) for w in rng.integers(16, min(top, 24) + 1, 14)] + [top] * 2)
    cases = [  # (alphabet, motif lengths)
        (DNA, [2] * 16),
        (DNA, sorted(int(w) for w in rng.integers(5, 16, 16))),
        (DNA, ragged(17)),
        (DNA, ragged(39)),
        (DNA, [10, 20, 33, 40, 50, 64, 77, 90, 100, 110, 115, 120, 125, 127, 128, 128]),
        (DNA, sorted(int(w) for w in rng.integers(5, 21, 2048))),
        (PROTEIN, [2, 3, 3, 4, 4, 4, 5, 5, 5, 5, 5, 5, 5, 5, 5, 5]),
        (PROTEIN, sorted(int(w) for w in rng.integers(5, 33, 256))),
    ]
    for alphabet, lengths in cases:
        k = len(alphabet.symbols)
        pssms = synthetic_motifs(rng, alphabet, lengths)
        ths = [p.score_distribution().score(max(1e-3, 4.0 ** -len(p))) for p in pssms]
        ths[::7] = [1e6] * len(ths[::7])  # never-pass lanes
        group = k3_group(pssms, ths)
        length = int(rng.integers(150_000, 250_000))
        s = rng.integers(0, k - 1, size=length).astype(np.uint8)
        for start in rng.integers(0, length - 300, size=30):  # wildcard runs
            s[start : start + int(rng.integers(1, 300))] = k - 1
        yield k, lengths, group, torch.from_numpy(s).to(DEVICE)


def check_prefilter(name, seq, args, m_max, what) -> float:
    """A prefilter kernel ``torch.equal`` to its plain version on every
    window that fits; returns the largest error (0.0)."""
    from lightmotif_tpu_torch.ops import multi_kernel, torch_ops

    got = getattr(multi_kernel, name)(seq, *args)
    want = getattr(torch_ops, name)(seq, *args)
    torch.cuda.synchronize()
    n = seq.shape[0] - m_max + 1
    if not torch.equal(got[:n], want[:n]):
        bad = int(torch.nonzero(got[:n] != want[:n])[0])
        raise SystemExit(f"{name}: kernel != plain at {bad} ({what}): "
                         f"{got[bad].item()} vs {want[bad].item()}")
    return max_abs_err(got[:n], want[:n])


def phase_k3(cases) -> float:
    """K3 against its plain version; returns the largest error."""
    worst = 0.0
    for k, lengths, (args, m_max, widths, _), sd in cases:
        worst = max(worst, check_prefilter(
            "prefilter_any8", sd, args, m_max, f"K={k}, m_max={m_max}, lanes={len(lengths)}"))
        log("k3", k=k, m_max=m_max, lanes=len(lengths), widths=widths,
            length=sd.shape[0], equal=True)
    return worst


def bench_k4_inputs(seq):
    """K4 at bench.py's shape: the padded genome and the u8 table of 1,024
    lanes of m = 15 with thresholds 2,400 written by hand (seed 11)."""
    from lightmotif_tpu_torch.ops import multi, multi_kernel
    from lightmotif_tpu_torch.ops.pipeline import DeviceSequence

    rng = np.random.default_rng(11)
    m, k, count = BENCH_K4_M, 5, BENCH_K4_LANES
    dms = rng.integers(0, 200, size=(count, m, k)).astype(np.float32)
    dms[:, :, 4] = 0.0
    filters_t = multi_kernel.pack_filters_any(dms, np.full(count, BENCH_K4_THRESHOLD), k)
    filters_t[multi_kernel._lanes_for(k) - 1, :] = -float(BENCH_K4_THRESHOLD)
    table = [torch.from_numpy(a).to(DEVICE) for a in multi.pack_filters_k4(filters_t, k)]
    return DeviceSequence(seq, DEVICE).data, table, m


def phase_k4k5(cases, seq) -> dict:
    """K4 and K5 against their plain versions on K3's cases, and K4 at
    bench.py's shape over the genome; returns the largest error of each."""
    worst = {"prefilter_any": 0.0, "prefilter_any16": 0.0}
    for k, lengths, (_, m_max, widths, tables), sd in cases:
        for name, args in tables.items():
            worst[name] = max(worst[name], check_prefilter(
                name, sd, args, m_max, f"K={k}, m_max={m_max}, lanes={len(lengths)}"))
        log("k4k5", k=k, m_max=m_max, lanes=len(lengths), widths=widths,
            length=sd.shape[0], equal=True)
    data, table, m = bench_k4_inputs(seq)
    worst["prefilter_any"] = max(worst["prefilter_any"], check_prefilter(
        "prefilter_any", data, table, m, "bench shape"))
    log("k4k5", shape=f"bench: genome x {BENCH_K4_LANES} lanes, m={m}, "
        f"thresholds {BENCH_K4_THRESHOLD}", equal=True)
    return worst


def brute_force(pssms, thresholds, dseq):
    """Per-PSSM hits on the card: K1, ``>= threshold``, ``nonzero``.
    Returns (motif ids, positions, score bits with -0.0 read as +0.0)."""
    from lightmotif_tpu_torch.ops import kernels

    ids, pos, scores = [], [], []
    for i, (p, t) in enumerate(zip(pssms, thresholds)):
        n = dseq.length - len(p) + 1
        if n <= 0:
            continue
        w = torch.from_numpy(np.ascontiguousarray(p.data, np.float32)).to(DEVICE)
        s = kernels.score_f32(dseq.data, w, n)[:n]
        hit = torch.nonzero(s >= torch.tensor(t, device=DEVICE)).flatten()
        ids.append(torch.full_like(hit, i))
        pos.append(hit)
        scores.append(s[hit])
    return (torch.cat(ids).cpu().numpy(), torch.cat(pos).cpu().numpy(),
            (torch.cat(scores) + 0.0).cpu().numpy().view(np.uint32))


def check_scan(name, got, want) -> None:
    mo, pos, sc = got
    bits = (sc + np.float32(0.0)).view(np.uint32)
    if not (np.array_equal(mo, want[0]) and np.array_equal(pos, want[1])
            and np.array_equal(bits, want[2])):
        raise SystemExit(f"{name}: hits != brute force "
                         f"({len(mo)} hits vs {len(want[0])})")


def stage_inputs(group, dseq, lengths):
    """The inputs of phase C and the pairs kernel in one group's
    one-segment scan of a resident sequence, as ``multi.scan_groups``
    makes them: (chunk, lanes' valid windows int32, the group's prefilter
    output)."""
    from lightmotif_tpu_torch.ops import multi, multi_kernel

    n_valid = np.maximum(dseq.length - np.asarray(lengths)[group["ids"]] + 1, 0)
    n_max = int(n_valid.max())
    chunk = dseq.data[: n_max + group["m_max"] - 1]
    lanes = (dseq.length + 1 - group["len_dev"]).clamp(0, n_max).to(torch.int32)
    mode = next(name for name in multi.PREFILTERS if name in group)
    maxv = getattr(multi_kernel, multi.PREFILTERS[mode])(chunk, *group[mode])
    return chunk, lanes, maxv


def check_stages(group, chunk, lanes, maxv, cap=None, cap_hits=None) -> dict:
    """Phase C and the pairs kernel of one group ``torch.equal`` to their
    plain versions on the card (bits of every candidate row; counters;
    positions, lanes and f32 bits of the kept hits), each plain version on
    the plain one's inputs.  By default the capacities fit: the next power
    of two of the candidates and of the pairs.  Returns the counts, the
    capacities and the inputs of the kernels."""
    from lightmotif_tpu_torch.ops import multi, multi_stages

    n_cand = int((maxv >= 0).sum())
    cap = cap or 1 << max(n_cand - 1, 1).bit_length()
    cand, count = multi.compact_candidates(maxv, cap)
    bits, pcnt = multi_stages.phase_c_bits(chunk, cand, count, *group["phase_c"], lanes)
    want_bits = multi_stages.phase_c_bits_plain(chunk, cand, count, *group["phase_c"], lanes)
    want_pcnt = multi_stages.row_popcounts(want_bits, count)
    rows = min(n_cand, cap)
    if cap_hits is None:
        probe = multi_stages.pairs_rescore_plain(want_bits, cand, count, chunk, group["pssm"],
                                                 group["th"], 1)[0]
        cap_hits = 1 << max(int(probe[1]) - 1, 1).bit_length()
    counts, packed = multi_stages.pairs_rescore(bits, pcnt, cand, count, chunk, group["pssm"],
                                                group["th"], cap_hits)
    want_counts, want_packed = multi_stages.pairs_rescore_plain(
        want_bits, cand, count, chunk, group["pssm"], group["th"], cap_hits)
    torch.cuda.synchronize()
    n_kept = int(want_counts[2])
    # the worst difference of every check: a pass bit (0 or 1), and the
    # kept hits' positions, lanes and f32 scores
    top = max(n_kept, min(int(counts[2]), cap_hits))
    errs = {"phase_c_bits": max(float((bits[:rows] != want_bits[:rows]).any()),
                                max_abs_err(pcnt, want_pcnt)),
            "pairs_rescore": max(max_abs_err(packed[:2, :top], want_packed[:2, :top]),
                                 max_abs_err(packed[2, :top].view(torch.float32),
                                             want_packed[2, :top].view(torch.float32)))}
    for name, err in errs.items():
        STAGE_ERRS[name] = max(STAGE_ERRS[name], err)
    if not torch.equal(bits[:rows], want_bits[:rows]):
        bad = int(torch.nonzero((bits[:rows] != want_bits[:rows]).any(1))[0])
        raise SystemExit(f"phase_c_bits != plain at candidate row {bad} of {rows}")
    if not torch.equal(pcnt, want_pcnt):
        bad = int(torch.nonzero(pcnt != want_pcnt)[0])
        raise SystemExit(f"phase_c_bits' row popcounts != plain at row {bad}")
    if not (torch.equal(counts, want_counts)
            and torch.equal(packed[:, :n_kept], want_packed[:, :n_kept])):
        raise SystemExit(f"pairs_rescore != plain: counts {counts.tolist()} vs "
                         f"{want_counts.tolist()}")
    got = counts.tolist()
    return {"candidates": got[0], "pairs": got[1], "kept": got[2], "cap": cap,
            "cap_hits": cap_hits, "args": (chunk, cand, count, bits, pcnt, lanes)}


#: The worst difference of each new kernel from its plain version over
#: every :func:`check_stages` of the run.
STAGE_ERRS = {"phase_c_bits": 0.0, "pairs_rescore": 0.0}


def stage_bounds(group, row) -> dict:
    """The least time of each new kernel on one group's inputs:
    ``phase_c_bits``, the int8 tensor-core operations of its sums (2 per
    multiply-add, over every candidate row, the K-wide one-hot of each
    row its chunk needs, 16 lanes a chunk, each plane) against the
    candidates' windows, the candidate list and the bit words; the
    ``pairs_rescore``, the bytes of the listed rows' bit words and
    candidates read once, the pairs' windows and table rows, and the
    kept hits written once, against its f32 adds."""
    planes, chunk_m = group["phase_c"][0], group["phase_c"][1]
    n_planes, n_chunks, _, rows, k = planes.shape
    n = min(row["candidates"], row["cap"])
    ops = 2 * n_planes * n * k * 16 * int(chunk_m.sum())
    c_bytes = n * (rows + 8 + 4 * n_chunks) + planes.nbytes + chunk_m.nbytes + 64 * n_chunks
    m = group["pssm"].shape[1]
    pairs = min(row["pairs"], row["cap_hits"])
    p_bytes = n * (4 * n_chunks + 8) + pairs * m * 5 + 12 * row["kept"] + 16
    return {"phase_c_bits": bound(c_bytes, ops, "int8"),
            "pairs_rescore": bound(p_bytes, pairs * max(m - 1, 1), "f32")}


def time_stages(group, row) -> dict:
    """Each new kernel on a group's inputs beside its plain version
    (CUDA events; in turns plain, kernel, kernel, plain), its bound, and
    "none" for the library: no one PyTorch call computes either."""
    from lightmotif_tpu_torch.ops import multi_stages

    chunk, cand, count, bits, pcnt, lanes = row["args"]
    pc = group["phase_c"]
    fns = {
        "phase_c_bits": (lambda: multi_stages.phase_c_bits(chunk, cand, count, *pc, lanes),
                         lambda: multi_stages.phase_c_bits_plain(chunk, cand, count, *pc,
                                                                 lanes)),
        "pairs_rescore": (lambda: multi_stages.pairs_rescore(
            bits, pcnt, cand, count, chunk, group["pssm"], group["th"], row["cap_hits"]),
            lambda: multi_stages.pairs_rescore_plain(
                bits, cand, count, chunk, group["pssm"], group["th"], row["cap_hits"])),
    }
    bounds = stage_bounds(group, row)
    out = {}
    for name, (kernel, plain) in fns.items():
        p1 = time_cuda(plain, runs=3)
        k1 = time_cuda(kernel, repeat=5)
        k2 = time_cuda(kernel, repeat=5)
        p2 = time_cuda(plain, runs=3)
        out[name] = {"ms": min(k1, k2), "plain_ms": min(p1, p2), "bound_ms": bounds[name][0],
                     "bound_by": bounds[name][1], "library_ms": None,
                     "runs": f"k={k1:.4f},{k2:.4f} p={p1:.4f},{p2:.4f}"}
    return out


def phase_stages(ms, what: str, timed: bool = False) -> dict:
    """Phase C and the pairs kernel against their plain versions on every
    group of a scanner's last scan, with each group's candidate, pair and
    kept counts and phase C's geometry (and, ``timed``, each kernel's ms,
    plain ms and bound, and the two together against the sum of their
    bounds, since phase C now counts each row's pairs for the pairs
    kernel).  Returns group 0's times (``timed``)."""
    from lightmotif_tpu_torch.ops import multi_stages

    first = None
    for gi, group in enumerate(ms._groups):
        row = check_stages(group, *stage_inputs(group, ms._dseq, ms.lengths))
        fields = {"phase_c_geometry": multi_stages.phase_c_geometry(group["phase_c"][0])}
        if timed:
            times = time_stages(group, row)
            first = first or times
            for name, t in times.items():
                fields[name] = (f"ms={t['ms']:.4f} plain_ms={t['plain_ms']:.4f} "
                                f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}) "
                                f"runs={t['runs']}")
            fields["both"] = (f"ms={sum(t['ms'] for t in times.values()):.4f} "
                              f"bound_ms={sum(t['bound_ms'] for t in times.values()):.4f}")
        log("stages", workload=what, group=gi, lanes=group["phase_c"][2].shape[0],
            rows=group["m_max"], candidates=row["candidates"], pairs=row["pairs"],
            kept=row["kept"], cap=row["cap"], cap_hits=row["cap_hits"], equal_plain=True,
            launches=f"phase_c_bits 1 + pairs_rescore {multi_stages.PAIRS_KERNELS} a segment",
            **fields)
    return first


def dense_hits_check() -> None:
    """The kernels on a group whose candidate rows hold more pairs than a
    row lists (thresholds at p = 0.02 over 2,048 lanes): at cap_hits 2**16
    each row lists its first 64 and hit_need is 4,096 x the fullest row's
    count, equal to the plain version's; at room for every pair, equal
    again."""
    from lightmotif_tpu_torch import DNA, EncodedSequence
    from lightmotif_tpu_torch.ops import multi
    from lightmotif_tpu_torch.ops.pipeline import DeviceSequence

    rng = np.random.default_rng(0xD15E)
    pssms = synthetic_motifs(rng, DNA, sorted(int(w) for w in rng.integers(5, 9, 2048)))
    ths = np.asarray([p.score_distribution().score(0.02) for p in pssms], np.float32)
    k = len(DNA.symbols)
    stack, lengths = multi.stack_motifs([p.data for p in pssms], k)
    (group,) = multi.database_groups(stack, lengths, ths, np.arange(len(pssms)), k, DEVICE,
                                     len(pssms))
    dseq = DeviceSequence(EncodedSequence(rng.integers(0, 4, 200_000).astype(np.uint8)),
                          DEVICE)
    inputs = stage_inputs(group, dseq, lengths)
    for cap_hits in (1 << 16, None):
        row = check_stages(group, *inputs, cap_hits=cap_hits)
        log("stages", workload="dense hits (p = 0.02, 2,048 lanes, 200,000 bp)",
            candidates=row["candidates"], pairs=row["pairs"], kept=row["kept"],
            cap_hits=row["cap_hits"], truncated=row["pairs"] > row["cap_hits"],
            equal_plain=True)


def phase_database(seq):
    """The database path at full size; returns (scanner, its launches,
    the brute force's hits, the forward strands' count matrices)."""
    from lightmotif_tpu_torch.ops import multi
    from lightmotif_tpu_torch.ops.pipeline import DeviceSequence
    from lightmotif_tpu_torch.scanner import MultiScanner

    t0 = time.perf_counter()
    pssms, ths, counts = synthetic_database(DB_MOTIFS, DB_SEED)
    log("database", pssms=len(pssms), build_s=f"{time.perf_counter() - t0:.3f}",
        lengths=f"{min(len(p) for p in pssms)}-{max(len(p) for p in pssms)}")

    ms = MultiScanner(pssms, thresholds=ths, device=DEVICE)
    reset_launches()
    t0 = time.perf_counter()
    got = ms.scan_arrays(seq)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = launch_counts()
    reruns = dict(multi.RERUNS)
    if (launches["prefilter_any8"] < 1
            or {k: launches[k] for k in group_launches(0)} != group_launches(len(ms._groups))):
        raise SystemExit(f"the database scan's launches {launches}, re-runs {reruns}")
    routing = ms._route()
    log("database", live=len(routing["short_idx"]) + len(routing["dense_idx"]),
        pruned=len(pssms) - len(routing["short_idx"]) - len(routing["dense_idx"]),
        groups=len(ms._groups), group_rows=[g["m_max"] for g in ms._groups],
        dense=len(routing["dense_idx"]), hits=len(got[0]),
        first_scan_s=f"{first_s:.3f}", launches=launches, reruns=reruns,
        capacities=ms._group_state, host_reads=ms.host_reads)

    t0 = time.perf_counter()
    want = brute_force(pssms, ths, DeviceSequence(seq, DEVICE))
    check_scan("database", got, want)
    log("database", check="scan_arrays == per-PSSM K1 brute force", segments=1,
        hits=len(want[0]), brute_force_s=f"{time.perf_counter() - t0:.3f}")

    n = len(seq) - 5 + 1
    five = MultiScanner(pssms, thresholds=ths, device=DEVICE)
    five.SEGMENT = -(-n // 5)
    check_scan("database, 5 segments", five.scan_arrays(seq), want)
    log("database", check="scan_arrays == brute force", segments=5,
        segment=five.SEGMENT)
    del five
    graph_memory(pssms, ths, seq)

    # a seed capacity of 64: every group overflows and re-runs until it
    # fits, with the same hits; then one read per scan
    small = MultiScanner(pssms, thresholds=ths, capacity=64, device=DEVICE)
    multi.reset_reruns()
    check_scan("database, capacity 64", small.scan_arrays(seq), want)
    first_reads, reruns = small.host_reads, dict(multi.RERUNS)
    small.host_reads = 0
    check_scan("database, capacity 64, again", small.scan_arrays(seq), want)
    if not reruns["group"] or small.host_reads != 1:
        raise SystemExit(f"database, capacity 64: re-runs {reruns}, steady reads "
                         f"{small.host_reads}")
    log("database", check="a seed capacity of 64 ratchets to the same hits", reruns=reruns,
        first_scan_reads=first_reads, steady_reads=small.host_reads,
        capacities=small._group_state)

    # steady state: one read of the card per collect_arrays; the dispatch
    # (every group's stages) reads nothing, under the sync debug mode
    ms.host_reads = 0
    check_scan("database, steady", ms.collect_arrays(), want)
    steady_reads = ms.host_reads
    torch.cuda.synchronize()
    try:
        torch.cuda.set_sync_debug_mode("error")
        token = ms.dispatch()
    except RuntimeError as e:
        raise SystemExit(f"database: the dispatch read the card: {e}") from None
    finally:
        torch.cuda.set_sync_debug_mode("default")
    check_scan("database, dispatched under the sync debug mode", ms.fetch(token), want)
    if steady_reads != 1:
        raise SystemExit(f"database: {steady_reads} reads in one steady collect_arrays")
    if not token["replayed"]:
        raise SystemExit("database: the steady dispatch did not replay its graphs")
    log("database", check="MultiScanner.collect_arrays reads the card once in steady state; "
        "its dispatch reads nothing (sync debug mode error)", host_reads=steady_reads,
        entries=len(token["entries"]), replayed=token["replayed"],
        graphs_captured=ms.replays.captured, graphs_replayed=ms.replays.replayed)
    return ms, launches, want, counts


def settle() -> None:
    """Every card's work done, garbage collected and the caching
    allocator's free blocks released."""
    import gc

    sync_all()
    gc.collect()
    torch.cuda.empty_cache()


def graph_pools(before=()) -> dict:
    """The private memory pools on the current card (the CUDA graphs')
    but those in ``before``, from the caching allocator's snapshot: per
    pool its reserved MiB, the MiB of its live blocks (the graphs'
    outputs), its segments and the largest of them."""
    mib, pools = 1 << 20, {}
    card = torch.cuda.current_device()
    for seg in torch.cuda.memory_snapshot():
        pool = tuple(seg.get("segment_pool_id", (0, 0)))
        if seg.get("device", card) != card or pool == (0, 0) or pool in before:
            continue
        row = pools.setdefault(pool, [0, 0, 0, 0])
        row[0] += seg["total_size"]
        row[1] += seg.get("allocated_size", 0)
        row[2] += 1
        row[3] = max(row[3], seg["total_size"])
    return {pool: {"reserved_mib": round(r / mib, 2), "live_mib": round(a / mib, 2),
                   "segments": n, "largest_mib": round(big / mib, 2)}
            for pool, (r, a, n, big) in pools.items()}


def graph_row(ms, seq, want, what: str) -> dict:
    """What the CUDA graphs of a steady scan of ``seq`` keep, beside one
    eager scan's peak (the issue before graphs; the timing hook keeps a
    scan eager), for a ``MultiScanner`` that has scanned ``seq`` once
    (its capacities settled, nothing captured): ``memory_reserved`` after
    four steady scans beside before them, with the caching allocator's
    free blocks released (``kept``); of that, the live tensors (the
    graphs' outputs, ``live``); the most that was allocated at once during
    the steady scans, their captures included, beyond what was before them
    (``steady_peak``), so that ``kept`` less it is the rounding of the
    graphs' pool; and each pool.  Every scan's hits must equal ``want``."""
    mib = 1 << 20
    ms.mark = lambda stage, count: None
    settle()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    check_scan(f"{what}, eager", ms.scan_arrays(seq), want)
    peak = torch.cuda.max_memory_allocated() - base
    ms.mark = None
    settle()
    reserved, allocated = torch.cuda.memory_reserved(), torch.cuda.memory_allocated()
    before = set(graph_pools())
    torch.cuda.reset_peak_memory_stats()
    for _ in range(4):
        check_scan(what, ms.scan_arrays(seq), want)
    steady_peak = torch.cuda.max_memory_allocated() - allocated
    settle()
    kept = torch.cuda.memory_reserved() - reserved
    return {"eager_peak_mib": round(peak / mib, 2), "graphs_keep_mib": round(kept / mib, 2),
            "live_mib": round((torch.cuda.memory_allocated() - allocated) / mib, 2),
            "steady_peak_mib": round(steady_peak / mib, 2),
            "rounding_mib": round((kept - steady_peak) / mib, 2),
            "pools": list(graph_pools(before).values()), "captured": ms.replays.captured,
            "replayed": ms.replays.replayed,
            "positions": seq.length if hasattr(seq, "length") else len(seq)}


def graph_memory(pssms, ths, seq, segment: int | None = None, counts=(2, 8),
                 phase: str = "database") -> None:
    """The device memory that the CUDA graphs of a steady database scan
    keep, beside the peak of one eager scan (:func:`graph_row`), on
    prefixes of ``seq`` of ``counts`` segments of ``segment`` window
    starts (default: an eighth of ``seq``; a count past the sequence's
    end takes all of it).  A capture reuses the memory its work frees, so
    the graphs keep about one eager scan's peak: this fails if they keep
    more than 1.5x it (+64 MiB of the allocator's rounding), or if what
    they keep grows with the number of segments faster than the eager
    peak does."""
    from lightmotif_tpu_torch.ops.pipeline import DeviceSequence
    from lightmotif_tpu_torch.scanner import MultiScanner

    mib, slack = 1 << 20, 64 << 20
    segment = -(-len(seq) // 8) if segment is None else int(segment)
    m_max = max(len(p) for p in pssms)
    rows = {}
    for n_seg in counts:
        part = DeviceSequence(seq[: n_seg * segment + m_max - 1], DEVICE)
        ms = MultiScanner(pssms, thresholds=ths, device=DEVICE)
        ms.SEGMENT = segment
        mo, pos, sc = ms.scan_arrays(part)  # packs the groups and settles the capacities
        want = (mo, pos, (sc + np.float32(0.0)).view(np.uint32))
        rows[n_seg] = graph_row(ms, part, want, f"graph memory, {n_seg} segments")
        del ms, part
        settle()
    log(phase, check="the graphs of a steady scan keep about one eager scan's peak, "
        "however many segments", segment=segment,
        **{f"segments_{n}": json.dumps(r) for n, r in rows.items()})
    for n_seg, row in rows.items():
        if row["graphs_keep_mib"] > 1.5 * row["eager_peak_mib"] + slack / mib:
            raise SystemExit(f"graph memory, {n_seg} segments: the graphs keep "
                             f"{row['graphs_keep_mib']} MiB, one eager scan peaks at "
                             f"{row['eager_peak_mib']} MiB")
    small, large = (rows[n] for n in counts)
    grew = large["graphs_keep_mib"] - small["graphs_keep_mib"]
    peak_grew = large["eager_peak_mib"] - small["eager_peak_mib"]
    if grew * mib > 1.5 * max(peak_grew, 0.0) * mib + slack:
        raise SystemExit(f"graph memory: what the graphs keep grows with the segments: "
                         f"{grew:.2f} MiB, the eager peak {peak_grew:.2f} MiB")


class ModeDatabase:
    """The database of a ``MultiScanner`` laid out for the prefilter
    modes through the package's own functions: its routing
    (``multi.route_motifs``), its groups in one mode
    (``multi.database_groups``) and their scan (``multi.scan_groups``)
    over the genome, resident on the card."""

    def __init__(self, ms, seq):
        from lightmotif_tpu_torch.ops import multi
        from lightmotif_tpu_torch.ops.pipeline import DeviceSequence
        from lightmotif_tpu_torch.scanner import MultiScanner

        self.ms = ms
        self.k = ms.pssms[0].alphabet.size
        self.short, dense = multi.route_motifs(ms.pssm_stack, ms.lengths, ms.thresholds,
                                               self.k, MultiScanner.dense_m_limit(self.k))
        if dense.size:
            raise SystemExit("modes: the database has dense motifs; the modes run no dense path")
        self.dseq = DeviceSequence(seq, DEVICE)
        self._discrete = None
        self.state = {}  # per mode: the groups' capacities, as a scanner keeps them

    def lanes(self, prefilter: str) -> int:
        """Lanes per group: the scanner's 2,048 for K3 and K5,
        K4_GROUP_LANES for K4."""
        from lightmotif_tpu_torch.scanner import MultiScanner

        return K4_GROUP_LANES if prefilter == "k4" else MultiScanner.GROUP_MOTIFS

    def discrete(self):
        """The u8 filters' inputs: each PSSM's ``to_discrete()`` matrix and
        ``scale()`` of its threshold, as tests/test_multi.py:275-282 builds
        them."""
        from lightmotif_tpu_torch.ops import multi

        if self._discrete is None:
            dms = [p.to_discrete() for p in self.ms.pssms]
            self._discrete = (
                multi.stack_motifs([d.data.astype(np.float32) for d in dms], self.k)[0],
                np.asarray([d.scale(t) for d, t in zip(dms, self.ms.thresholds)], np.int64))
        return self._discrete

    def groups(self, prefilter: str) -> list:
        from lightmotif_tpu_torch.ops import multi

        ms = self.ms
        return multi.database_groups(
            ms.pssm_stack, ms.lengths, ms.thresholds, self.short, self.k, DEVICE,
            self.lanes(prefilter), prefilter=prefilter,
            discrete=self.discrete() if prefilter == "k4" else None)

    def scan(self, groups, segment: int):
        """Hit arrays through ``groups``, sorted as ``scan_arrays`` sorts,
        with the groups' capacities kept from scan to scan."""
        from lightmotif_tpu_torch.ops import multi

        state = self.state.setdefault(id(groups), {})
        return multi.collect_entries(multi.scan_groups(
            self.dseq.data, self.dseq.length, self.ms.lengths, groups, self.k, segment,
            state=state), state=state)

    def segment_entry(self, prefilter: str):
        """The port's ``scan_multi_segment_fused``, given the first group's
        JAX filters as they come (``filters_fine`` and ``widths``, or
        ``filters_t``), over the whole genome in one segment.  Returns
        (the group's ids, its hit arrays sorted as ``scan_arrays`` sorts,
        the prefilter's launches)."""
        from lightmotif_tpu_torch.ops import multi, multi_kernel

        ms = self.ms
        ids, g = next(multi.pack_database(ms.pssm_stack, ms.lengths, ms.thresholds,
                                          self.short, self.k, self.lanes(prefilter)))
        filters = ({"filters_t": None, "filters_fine": (g["f_hi"], g["f_lo"]),
                    "widths": g["widths"]} if prefilter == "k5" else
                   {"filters_t": multi.pack_filters_u8(g, ids, *self.discrete(), self.k)})
        n_valid = np.zeros((1, g["f_hi"].shape[1]), np.int64)
        n_valid[0, : ids.size] = np.maximum(self.dseq.length - ms.lengths[ids] + 1, 0)
        chunk_len = int(n_valid.max()) + g["m_max"] - 1
        reset_launches()
        # capacities for every window and up to 2**20 pairs: no re-run
        pos, lanes, scores = multi.scan_multi_segment_fused(
            self.dseq.data, 0, n_valid, filters.pop("filters_t"), g["pssm"], g["th"],
            chunk_len, chunk_len, g["m_max"], self.k, cap_hits=1 << 20, **filters)
        torch.cuda.synchronize()
        launches = {k: v for k, v in launch_counts().items() if v}
        ids_dev = torch.as_tensor(ids, device=DEVICE)
        return ids, multi.sorted_hits([(pos, ids_dev[lanes], scores)]), launches


def same_hits(a, b) -> bool:
    return all(np.array_equal(x.view(np.uint8), y.view(np.uint8)) for x, y in zip(a, b))


def check_segment_entry(db, prefilter: str, mode_hits, what: str) -> None:
    """The segment entry's hits of the first group equal the mode's hits
    of that group's motifs, through one launch of the mode's kernel."""
    from lightmotif_tpu_torch.ops import multi

    ids, got, launches = db.segment_entry(prefilter)
    name = multi.PREFILTERS[prefilter]
    if launches != group_launches(1, name):
        raise SystemExit(f"{what}: scan_multi_segment_fused launches {launches}")
    sel = np.isin(mode_hits[0], ids)
    if not (len(got[0]) and same_hits(got, [a[sel] for a in mode_hits])):
        raise SystemExit(f"{what}: scan_multi_segment_fused != the mode's hits of group 0 "
                         f"({len(got[0])} vs {int(sel.sum())})")
    log("modes", check=f"{what}: scan_multi_segment_fused of group 0 == the mode's hits",
        lanes=ids.size, hits=len(got[0]), launches=launches)


def phase_modes(ms, seq, brute) -> tuple:
    """The u16 (K5) and u8 (K4) modes of the database core at full size,
    held to the K3 mode's hits (``ms.scan_arrays``) and, for K5, to the
    brute force in 1 and 5 segments; each mode must launch its kernel,
    phase C and the pairs kernel once per group and segment and once per
    re-run.  The segment entry, given group 0's JAX filters, must give
    that group's hits in each mode.  Phase C and the pairs kernel equal
    their plain versions on every group of each mode.  Returns (the
    ModeDatabase, K5 groups, the launches of the one-segment K5 run, the
    K4 launches)."""
    db = ModeDatabase(ms, seq)
    want = ms.scan_arrays(seq)
    n = len(seq) - int(ms.lengths.min()) + 1
    t0 = time.perf_counter()
    groups5 = db.groups("k5")
    pack_s = time.perf_counter() - t0
    launches5 = None
    for segments in (1, 5):
        segment = -(-n // segments)
        reset_launches()
        t0 = time.perf_counter()
        got = db.scan(groups5, segment)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs = {k: v for k, v in launch_counts().items() if v}
        if runs != group_launches(len(groups5) * segments, "prefilter_any16"):
            raise SystemExit(f"u16 mode, {segments} segments, {len(groups5)} groups: "
                             f"launches {runs}")
        launches5 = launches5 or runs
        check_scan(f"u16 mode, {segments} segments", got, brute)
        if not same_hits(got, want):
            raise SystemExit(f"u16 mode, {segments} segments: hits != the K3 mode's")
        log("modes", mode="u16 (K5)", segments=segments, groups=len(groups5),
            hits=len(got[0]), equal_k3_mode=True, equal_brute_force=True,
            launches=runs, first_scan_s=f"{wall:.3f}", pack_s=f"{pack_s:.3f}")
    check_segment_entry(db, "k5", want, "u16 mode")

    t0 = time.perf_counter()
    groups4 = db.groups("k4")
    pack_s = time.perf_counter() - t0
    reset_launches()
    t0 = time.perf_counter()
    got = db.scan(groups4, n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches4 = {k: v for k, v in launch_counts().items() if v}
    if launches4 != group_launches(len(groups4), "prefilter_any"):
        raise SystemExit(f"u8 mode, {len(groups4)} groups: launches {launches4}")
    # the genome has no wildcard, so the u8 test misses no hit
    if not same_hits(got, want):
        raise SystemExit("u8 mode: hits != the K3 mode's")
    log("modes", mode="u8 (K4)", segments=1, groups=len(groups4),
        group_lanes=K4_GROUP_LANES, group_rows=[g["m_max"] for g in groups4],
        hits=len(got[0]), equal_k3_mode=True, launches=launches4,
        scan_s=f"{wall:.3f}", pack_s=f"{pack_s:.3f}")
    check_segment_entry(db, "k4", want, "u8 mode")
    # phase C and the pairs kernel on every group of each mode
    for what, groups in (("u16 (K5) mode", groups5), ("u8 (K4) mode", groups4)):
        for gi, group in enumerate(groups):
            row = check_stages(group, *stage_inputs(group, db.dseq, ms.lengths))
            log("stages", workload=what, group=gi, lanes=group["phase_c"][2].shape[0],
                rows=group["m_max"], candidates=row["candidates"], pairs=row["pairs"],
                kept=row["kept"], equal_plain=True)
    return db, groups5, launches5, launches4


def genome_records(seq):
    """The genome cut into seeded records of 50-2,000 bp; every
    RECORD_SHORT_EVERY-th record is 1-14 bp, shorter than MX000001."""
    from lightmotif_tpu_torch import EncodedSequence

    rng = np.random.default_rng(RECORD_SEED)
    lengths = rng.integers(RECORD_LENGTHS[0], RECORD_LENGTHS[1] + 1, len(seq) // 40)
    lengths[::RECORD_SHORT_EVERY] = rng.integers(1, 15, lengths[::RECORD_SHORT_EVERY].size)
    ends = np.cumsum(lengths)
    ends = ends[ends < len(seq)]
    starts = np.concatenate([[0], ends[:-1]])
    data = np.asarray(seq.data)
    return [EncodedSequence(data[a:b].copy()) for a, b in zip(starts, ends)]


def phase_batch(pssm, seq, ms) -> tuple:
    """Batched records: BatchReducer against the per-record host oracle,
    BatchScanner at p = 1e-5 against per-record Scanners, and
    MultiBatchScanner with the database against the brute force over the
    concatenation, windows inside one record.  Each class's launches are
    counted from 0 over its own call, before its oracle runs: K1 once
    for the reducer, the segment kernel once per segment for the scanner, K3, phase C and
    the pairs kernel once per motif group and segment for the database
    (its second scan: the first settles the capacities).  Returns (records, the
    BatchReducer, the MultiBatchScanner, its hit arrays)."""
    from lightmotif_tpu_torch import Scanner
    from lightmotif_tpu_torch.batch import BatchReducer, BatchScanner, MultiBatchScanner
    from lightmotif_tpu_torch.ops import multi
    from lightmotif_tpu_torch.scanner import DEFAULT_SEGMENT, MultiScanner

    def expect(what, launches, want):
        if {k: v for k, v in launches.items() if v} != want:
            raise SystemExit(f"{what}: launches {launches}, expected {want}")

    records = genome_records(seq)
    m = len(pssm)
    n_short = sum(len(r) < m for r in records)
    br = BatchReducer(pssm, records, device=DEVICE)
    reset_launches()
    am, mx = br.argmax()
    torch.cuda.synchronize()
    launches_br = launch_counts()
    expect("BatchReducer.argmax", launches_br, {"score_f32": 1})
    for i, r in enumerate(records):
        if len(r) < m:
            ok = am[i] == -1 and mx[i] == -np.inf
        else:
            host = pssm.score_host(r)
            ok = (f32_bits(mx[i]) == f32_bits(host.max())
                  and am[i] == np.nonzero(host == host.max())[0][-1])
        if not ok:
            raise SystemExit(f"BatchReducer != host oracle at record {i}: ({mx[i]}, {am[i]})")
    log("batch", records=len(records), short=n_short, bp=sum(map(len, records)),
        check="BatchReducer == per-record host oracle", slot=br.slot,
        launches=launches_br)

    t = pssm.score_distribution().score(1e-5)
    bs = BatchScanner(pssm, records, threshold=t, device=DEVICE)
    reset_launches()
    got = bs.collect()
    launches_bs = launch_counts()
    # one concatenation of the records with m - 1 separators each
    n_windows = sum(map(len, records)) + len(records) * (m - 1) - m + 1
    segments = -(-n_windows // DEFAULT_SEGMENT) + bs._scanner.reruns
    expect("BatchScanner.collect", launches_bs, {"scan_segment": segments})
    for i, (r, hits) in enumerate(zip(records, got)):
        own = Scanner(pssm, r, threshold=t, device=DEVICE).collect()
        if [(h.position, f32_bits(h.score)) for h in hits] != \
                [(h.position, f32_bits(h.score)) for h in own]:
            raise SystemExit(f"BatchScanner != Scanner at record {i}")
    log("batch", check="BatchScanner == per-record Scanner", threshold=t,
        hits=sum(map(len, got)), launches=launches_bs)

    mbs = MultiBatchScanner(ms.pssms, thresholds=ms.thresholds, device=DEVICE)
    dseq, offsets, lengths = prepared = mbs.prepare(records)
    mbs.rebind_prepared(prepared)
    mbs.collect_arrays()  # the capacities settle
    reset_launches()
    rec, mo, local, sc = mbs.collect_arrays()
    launches_mbs = launch_counts()
    # K3 once per group and segment; every motif of this database is short
    k = ms.pssms[0].alphabet.size
    short, _ = multi.route_motifs(ms.pssm_stack, ms.lengths, ms.thresholds, k,
                                  MultiScanner.dense_m_limit(k))
    size = MultiScanner.GROUP_MOTIFS
    want_k3 = sum(-(-(dseq.length - int(ms.lengths[short[s:s + size]].min()) + 1)
                    // MultiScanner.SEGMENT) for s in range(0, short.size, size))
    expect("MultiBatchScanner.collect_arrays", launches_mbs, group_launches(want_k3))
    ids, pos, bits = brute_force(ms.pssms, ms.thresholds, dseq)
    r = np.searchsorted(offsets, pos, side="right") - 1
    lo = pos - offsets[r]
    keep = lo <= lengths[r] - ms.lengths[ids]
    if not (np.array_equal(rec, r[keep]) and np.array_equal(mo, ids[keep])
            and np.array_equal(local, lo[keep])
            and np.array_equal((sc + np.float32(0.0)).view(np.uint32), bits[keep])):
        raise SystemExit(f"MultiBatchScanner != brute force ({len(mo)} hits vs {keep.sum()})")
    log("batch", check="MultiBatchScanner == brute force inside records",
        pssms=len(ms.pssms), hits=len(mo), dropped_across_records=int((~keep).sum()),
        groups=-(-short.size // size), launches=launches_mbs)
    return records, br, mbs, (rec, mo, local, sc)


def write_jaspar16(path, counts, prefix: str) -> None:
    """Count matrices as a JASPAR16 file, one record ``{prefix}{i}`` each."""
    from lightmotif_tpu_torch import DNA

    with open(path, "w") as fh:
        for i, c in enumerate(counts):
            fh.write(f">{prefix}{i:05d}.1\tsynthetic {i}\n")
            for sym in "ACGT":
                col = np.asarray(c.data)[:, DNA.symbols.index(sym)]
                fh.write(f"{sym}  [ {' '.join(str(int(v)) for v in col)} ]\n")


def write_fasta(path, records) -> None:
    """``(name, EncodedSequence)`` records as FASTA, 80 symbols a line."""
    with open(path, "w") as fh:
        for name, s in records:
            text = str(s)
            fh.write(f">{name}\n")
            fh.writelines(text[i : i + 80] + "\n" for i in range(0, len(text), 80))


def cli_rows(path):
    """The rows of a CLI TSV as arrays: (seq_index - 1, motif_index - 1,
    strand is "-", pos, score as f32 bits with -0.0 read as +0.0)."""
    with open(path) as fh:
        lines = fh.read().splitlines()
    if lines[0] != CLI_HEADER:
        raise SystemExit(f"cli: bad TSV header {lines[0]!r}")
    cols = list(zip(*(line.split("\t") for line in lines[1:]))) or [()] * 8
    score = np.asarray([float(v) for v in cols[6]], np.float64).astype(np.float32)
    return (np.asarray(cols[0], np.int64) - 1, np.asarray(cols[2], np.int64) - 1,
            np.asarray([s == "-" for s in cols[5]], bool), np.asarray(cols[4], np.int64),
            (score + np.float32(0.0)).view(np.uint32))


def cli_flights(lengths, gap: int, flight_bytes: int) -> list:
    """The record lengths of each flight the CLI's reader makes
    (``lightmotif_tpu_torch.cli._read_flights``): batched flights of at
    most ``flight_bytes`` encoded bytes with their gaps, a record too big
    for one alone."""
    flights, cur, total = [], [], 0
    for n in lengths:
        need = int(n) + gap
        if cur and total + need > flight_bytes:
            flights.append(cur)
            cur, total = [], 0
        if need > flight_bytes:
            flights.append([int(n)])
        else:
            cur.append(int(n))
            total += need
    return flights + ([cur] if cur else [])


def run_cli(args: list, what: str) -> tuple:
    """``cli.main(args)`` in this process with the launch counts reset
    just before and read just after; returns (launches, wall seconds, the
    ``cli_timing`` fields)."""
    import contextlib
    import io

    from lightmotif_tpu_torch import cli

    err = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(err):
        rc = cli.main([*args, "-q"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    if rc != 0:
        raise SystemExit(f"cli {what}: exit {rc}")
    timing = [json.loads(line) for line in err.getvalue().splitlines()
              if line.startswith('{"event": "cli_timing"')]
    return launches, wall, timing[-1] if timing else None


def cli_subprocess(args: list, cache, what: str) -> dict:
    """``python -X importtime -m lightmotif_tpu_torch.cli`` from the
    checkout with ``LIGHTMOTIF_TPU_COMPILE_CACHE`` at ``cache``; fails if
    it imports JAX or the JAX package.  Returns its wall and
    ``cli_timing``."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, LIGHTMOTIF_TPU_COMPILE_CACHE=str(cache),
               PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-X", "importtime", "-m", "lightmotif_tpu_torch.cli", *args],
        cwd=root, env=env, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise SystemExit(f"cli {what}: exit {proc.returncode}\n{proc.stderr[-4000:]}")
    modules = {line.rsplit("|", 1)[-1].strip() for line in proc.stderr.splitlines()
               if line.startswith("import time:") and "|" in line}
    bad = sorted(m for m in modules if m.split(".")[0] in ("jax", "jaxlib", "lightmotif_tpu"))
    if bad or "lightmotif_tpu_torch" not in modules:
        raise SystemExit(f"cli {what}: imported {bad or 'no lightmotif_tpu_torch'}")
    timing = [json.loads(line) for line in proc.stderr.splitlines()
              if line.startswith('{"event": "cli_timing"')]
    return {"wall_s": wall, "timing": timing[-1] if timing else None,
            "modules": len(modules)}


def cli_split(db_file, seq) -> None:
    """Where the CLI's database x genome run spends its host time, stage
    by stage through the CLI's own functions: motif preparation, the
    first ``_scan_all`` (the scanner, its packing, the scan and a
    ``MultiHit`` per hit), a second one on the packed database, the scan's
    arrays alone, a p-value per hit and the TSV rows."""
    from lightmotif_tpu_torch import cli

    args = cli.build_parser().parse_args(
        ["-m", db_file, "--format", "jaspar16", "-s", "-", "-o", "-",
         "-P", str(DB_PVALUE), "--reverse"])
    split = {}

    def timed(key, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        split[key] = time.perf_counter() - t0
        return out

    jobs = timed("prepare_motifs_s", lambda: cli.prepare_motifs(args))
    cache = {}
    timed("first_scan_all_s", lambda: list(cli._scan_all(jobs, seq, args, DEVICE, cache)))
    rows = timed("second_scan_all_s",
                 lambda: list(cli._scan_all(jobs, seq, args, DEVICE, cache)))
    timed("scan_arrays_s", lambda: cache["single"].scan_arrays(seq))
    pvs = timed("pvalues_s", lambda: [job.dist.pvalue(hit.score) for job, _, hit in rows])
    timed("rows_s", lambda: [
        f"1\tgenome\t{job.index + 1}\t{job.name}\t{hit.position}\t{strand}\t"
        f"{np.float32(hit.score)}\t{pv:e}\n" for (job, strand, hit), pv in zip(rows, pvs)])
    log("cli", split="database x genome through the CLI's functions", rows=len(rows),
        **{k: f"{v:.3f}" for k, v in split.items()})


def phase_cli(pssm, seq, ms, counts, records, batch_hits, scanner_hits, brute) -> None:
    """The FIMO-like CLI on the card, through its files: the synthetic
    database written as a JASPAR16 file, the genome and the batch phase's
    records as FASTA, MX000001 as a one-motif JASPAR16 file.

    In this process (``cli.main``, the launch counts reset before each run
    and read after): database x genome at p = 1e-6 on both strands, equal
    to the per-PSSM brute force (positions and f32 bits) through the
    prefilter; database x records in one flight and in several (the reader
    thread, one flight in flight), the two TSVs byte-identical and equal
    to the batch phase's MultiBatchScanner hits, the prefilter launched
    once per group and flight segment; MX000001 x genome at the default
    p = 1e-5, equal to the main path's Scanner hits through K2.  Then
    ``python -m lightmotif_tpu_torch.cli`` in subprocesses, database x
    genome, cold (a fresh build directory: nvcc and the packing) and warm
    (the same directory): the cold build must not compile ``probes.cu``,
    neither process may import JAX, and each TSV equals the in-process one."""
    import os
    import shutil
    import tempfile

    from lightmotif_tpu_torch import CountMatrix, EncodedSequence

    work = tempfile.mkdtemp(prefix="chip-smoke-cli-")
    try:
        db_file = os.path.join(work, "database.jaspar16")
        write_jaspar16(db_file, counts, "SY")
        genome_fa = os.path.join(work, "genome.fa")
        write_fasta(genome_fa, [("genome", seq)])
        records_fa = os.path.join(work, "records.fa")
        write_fasta(records_fa, [(f"rec{i}", r) for i, r in enumerate(records)])
        mx_file = os.path.join(work, "MX000001.jaspar16")
        write_jaspar16(mx_file, [CountMatrix.from_sequences(
            EncodedSequence.encode(p) for p in PATTERNS)], "MX")

        # the motifs as the CLI loads them, against the synthetic ones
        from lightmotif_tpu_torch import load

        loaded = [m.counts.to_freq(0.1).to_scoring(None) for m in load(db_file)]
        differ = sum(not np.array_equal(np.asarray(a.data).view(np.uint32),
                                        np.asarray(b.data).view(np.uint32))
                     for a, b in zip(loaded, ms.pssms))
        log("cli", motifs=len(loaded), pssms_differing_in_bits_from_synthetic=differ,
            files=",".join(f"{os.path.basename(f)}={os.path.getsize(f)}" for f in
                           (db_file, genome_fa, records_fa, mx_file)))

        k3_launches = functools.partial(cli_group_steps, ms)

        def to_ids(motif, reverse):
            return motif + DB_MOTIFS * reverse

        # database x genome, one solo record through MultiScanner
        out = os.path.join(work, "genome.tsv")
        launches, wall, timing = run_cli(
            ["-m", db_file, "--format", "jaspar16", "-s", genome_fa, "-o", out,
             "-P", str(DB_PVALUE), "--reverse"], "database x genome")
        si, mo, rev, pos, bits = cli_rows(out)
        ids = to_ids(mo, rev)
        order = np.lexsort((pos, ids))
        if not (np.array_equal(ids[order], brute[0]) and np.array_equal(pos[order], brute[1])
                and np.array_equal(bits[order], brute[2]) and not si.any()):
            raise SystemExit(f"cli database x genome != brute force "
                             f"({len(pos)} rows vs {len(brute[0])})")
        # K3, phase C and the pairs kernel once per group and segment and
        # once per re-run at larger capacities
        want = group_launches(k3_launches(len(seq)))
        if {k: launches[k] for k in want} != want or launches["score_u8"]:
            raise SystemExit(f"cli database x genome: launches {launches}, expected {want}")
        log("cli", run="database x genome", rows=len(pos), equal_brute_force=True,
            launches=launches, wall_s=f"{wall:.3f}", cli_timing=json.dumps(timing))
        genome_tsv = open(out).read()
        cli_split(db_file, seq)

        # database x records, one flight and several
        rec_b, mo_b, local_b, sc_b = batch_hits
        order = np.lexsort((local_b, mo_b, rec_b))
        want_b = (rec_b[order], mo_b[order], local_b[order],
                  (sc_b[order] + np.float32(0.0)).view(np.uint32))
        gap = int(ms.lengths.max()) - 1
        tsvs = []
        for flight_bytes in (None, CLI_FLIGHT_BYTES):
            out = os.path.join(work, f"records-{flight_bytes}.tsv")
            extra = [] if flight_bytes is None else ["--flight-bytes", str(flight_bytes)]
            launches, wall, timing = run_cli(
                ["-m", db_file, "--format", "jaspar16", "-s", records_fa, "-o", out,
                 "-P", str(DB_PVALUE), "--reverse", *extra], "database x records")
            si, mo, rev, pos, bits = cli_rows(out)
            ids = to_ids(mo, rev)
            order = np.lexsort((pos, ids, si))
            got = (si[order], ids[order], pos[order], bits[order])
            if not all(np.array_equal(a, b) for a, b in zip(got, want_b)):
                raise SystemExit(f"cli database x records ({flight_bytes}): rows != "
                                 f"MultiBatchScanner ({len(pos)} vs {len(want_b[0])})")
            flights = cli_flights([len(r) for r in records], gap,
                                  flight_bytes or (16 << 20))
            want = group_launches(sum(
                k3_launches(sum(n + gap for n in f) if len(f) > 1 else f[0]) for f in flights))
            if {k: launches[k] for k in want} != want:
                raise SystemExit(f"cli database x records ({flight_bytes}): launches "
                                 f"{launches}, expected {want} over {len(flights)} flights")
            tsvs.append(open(out).read())
            log("cli", run="database x records", flight_bytes=flight_bytes or "default",
                flights=len(flights), rows=len(pos), equal_multibatchscanner=True,
                launches=launches, wall_s=f"{wall:.3f}", cli_timing=json.dumps(timing))
        if tsvs[0] != tsvs[1]:
            raise SystemExit("cli database x records: one flight and several differ")
        log("cli", check="database x records: TSV of one flight == TSV of several flights")

        # MX000001 x genome at the default p = 1e-5, through the Scanner
        out = os.path.join(work, "mx.tsv")
        launches, wall, timing = run_cli(
            ["-m", mx_file, "--format", "jaspar16", "-s", genome_fa, "-o", out],
            "MX000001 x genome")
        si, mo, rev, pos, bits = cli_rows(out)
        if not (np.array_equal(pos, scanner_hits[0]) and np.array_equal(bits, scanner_hits[1])
                and not (si.any() or mo.any() or rev.any())):
            raise SystemExit(f"cli MX000001 x genome != Scanner ({len(pos)} rows vs "
                             f"{len(scanner_hits[0])})")
        if launches["scan_segment"] < 1 or launches["score_u8"] or launches["prefilter_any8"]:
            raise SystemExit(f"cli MX000001 x genome: launches {launches}")
        log("cli", run="MX000001 x genome", rows=len(pos), equal_scanner=True,
            launches=launches, wall_s=f"{wall:.3f}", cli_timing=json.dumps(timing))

        # --mesh (the default mesh: every card): the same TSVs through the
        # sharded scanners, the prefilter and the segment kernel launched
        for what, mfile, extra, want_tsv, kernel in (
                ("database x genome", db_file, ["-P", str(DB_PVALUE), "--reverse"], genome_tsv,
                 "prefilter_any8"),
                ("MX000001 x genome", mx_file, [], open(out).read(), "scan_segment")):
            mesh_out = os.path.join(work, "mesh.tsv")
            launches, wall, timing = run_cli(
                ["-m", mfile, "--format", "jaspar16", "-s", genome_fa, "-o", mesh_out, *extra,
                 "--mesh"], f"{what} --mesh")
            if open(mesh_out).read() != want_tsv:
                raise SystemExit(f"cli {what} --mesh: TSV != the solo TSV")
            if launches[kernel] < 1 or launches["score_u8"]:
                raise SystemExit(f"cli {what} --mesh: launches {launches}")
            log("cli", run=f"{what} --mesh", rows=want_tsv.count("\n") - 1,
                equal_solo_tsv=True, launches=launches, wall_s=f"{wall:.3f}")

        # subprocesses: cold (a fresh build directory), then warm
        cache = os.path.join(work, "build")
        for what in ("cold", "warm"):
            out = os.path.join(work, f"genome-{what}.tsv")
            run = cli_subprocess(["-m", db_file, "--format", "jaspar16", "-s", genome_fa,
                                  "-o", out, "-P", str(DB_PVALUE), "--reverse"], cache, what)
            built = sorted(os.listdir(cache))
            if any(name.startswith("liblm-probes") for name in built):
                raise SystemExit(f"cli {what}: the build compiled probes.cu: {built}")
            if open(out).read() != genome_tsv:
                raise SystemExit(f"cli {what}: TSV != the in-process run's")
            log("cli", run=f"python -m lightmotif_tpu_torch.cli, database x genome, {what}",
                wall_s=f"{run['wall_s']:.3f}", rows=genome_tsv.count("\n") - 1,
                cli_timing=json.dumps(run["timing"]), jax_imported=False,
                modules_imported=run["modules"],
                build_dir=",".join(n for n in built if n.endswith(".so")))
    finally:
        shutil.rmtree(work, ignore_errors=True)


def phase_other_paths(seq) -> None:
    """The dense path and a protein database against the brute force;
    each scan must have launched K1 once per dense motif and K3 once per
    motif group."""
    from lightmotif_tpu_torch import DNA, PROTEIN, EncodedSequence
    from lightmotif_tpu_torch.ops.pipeline import DeviceSequence
    from lightmotif_tpu_torch.scanner import MultiScanner

    rng = np.random.default_rng(0xDE45E)
    cases = []
    long = synthetic_motifs(rng, DNA, [129, 150, 200, 257])
    cases.append(("dense", long, [p.score_distribution().score(1e-5) for p in long], seq))
    prot = synthetic_motifs(rng, PROTEIN, rng.integers(5, 41, PROTEIN_MOTIFS))
    pseq = EncodedSequence(rng.integers(0, 20, PROTEIN_LENGTH).astype(np.uint8), PROTEIN)
    cases.append(("protein", prot, [p.score_distribution().score(PROTEIN_PVALUE) for p in prot],
                  pseq))
    for name, pssms, ths, s in cases:
        ms = MultiScanner(pssms, thresholds=ths, device=DEVICE)
        reset_launches()
        got = ms.scan_arrays(s)
        torch.cuda.synchronize()
        launches = launch_counts()
        n_dense, n_groups = len(ms._route()["dense_idx"]), len(ms._groups)
        if launches["score_f32"] < n_dense or launches["prefilter_any8"] < n_groups:
            raise SystemExit(f"{name}: {n_dense} dense motifs and {n_groups} groups, "
                             f"but launches {launches}")
        check_scan(name, got, brute_force(pssms, ths, DeviceSequence(s, DEVICE)))
        log(name, check="scan_arrays == brute force", pssms=len(pssms),
            dense=n_dense, groups=n_groups, length=len(s), hits=len(got[0]),
            launches=launches)
        if not len(got[0]) or not n_dense:
            raise SystemExit(f"{name}: no hits or no dense motif, the check is vacuous")
        phase_stages(ms, name)  # the protein groups (the dense set has none)
    dense_hits_check()


def phase_imports() -> None:
    """Every module of the port imports without JAX and without the JAX
    package."""
    import importlib
    import pkgutil

    import lightmotif_tpu_torch

    names = [m.name for m in pkgutil.walk_packages(lightmotif_tpu_torch.__path__,
                                                   "lightmotif_tpu_torch.")]
    for name in names:
        importlib.import_module(name)
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "lightmotif_tpu"))
    if bad:
        raise SystemExit(f"imports: the port imported {bad}")
    log("imports", modules=len(names), jax_imported=False,
        new=",".join(n.split(".", 1)[1] for n in names if n.split(".")[1] in (
            "tfmpvalue", "sampler", "sampler_batch", "parallel", "utils")))


def phase_tfmpvalue(pssm) -> None:
    """MX000001's score at p = 1e-5 by exact TFM-PVALUE and by the MEME
    distribution, each with its host seconds (fresh objects, no cache)."""
    from lightmotif_tpu_torch import ScoreDistribution, TfmPvalue

    t0 = time.perf_counter()
    tfmp = TfmPvalue(pssm)
    exact = tfmp.score(1e-5)
    tfmp_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    meme = ScoreDistribution(pssm).score(1e-5)
    meme_s = time.perf_counter() - t0
    p_exact = tfmp.pvalue(exact)
    if not (np.isfinite(exact) and 0.0 < p_exact < 1.0
            and exact == pssm.score_for_pvalue(1e-5, method="tfmpvalue")):
        raise SystemExit(f"tfmpvalue: score {exact} with p-value {p_exact}")
    log("tfmpvalue", pssm="MX000001", pvalue=1e-5, tfmpvalue_score=exact,
        tfmpvalue_pvalue_of_score=p_exact, tfmpvalue_host_s=f"{tfmp_s:.4f}",
        meme_score=meme, meme_host_s=f"{meme_s:.4f}", difference=exact - meme)


def planted_strings(rng, lengths, motif: str) -> tuple:
    """Random DNA strings of the given lengths with ``motif`` planted once
    in each; returns (strings, planted positions)."""
    out, where = [], []
    for n in lengths:
        s = rng.integers(0, 4, int(n))
        p = int(rng.integers(0, int(n) - len(motif) + 1))
        s[p:p + len(motif)] = ["ACGT".index(c) for c in motif]
        out.append("".join(np.asarray(list("ACGT"))[s]))
        where.append(p)
    return out, np.asarray(where)


def phase_sampler() -> int:
    """The host Gibbs sampler: 16 sequences of 40,000 bp and 16 of 500 bp
    with MX000001's first site planted, 200 OOPS steps on the card and
    on the CPU from the same numpy seed.  The trajectories must be
    identical at every step, and K1 must launch once per long hold-out
    drawn (and nothing else) on the card.  K1 at a long hold-out's shape
    is timed beside its plain version on the card and on the host CPU
    (what a CPU step pays per long hold-out).  Returns K1's launches."""
    from lightmotif_tpu_torch import EncodedSequence
    from lightmotif_tpu_torch import sampler as smod
    from lightmotif_tpu_torch.ops import kernels, torch_ops
    from lightmotif_tpu_torch.ops.pipeline import DeviceSequence

    rng = np.random.default_rng(SAMPLER_SEED)
    lengths = [SAMPLER_LONG] * SAMPLER_COUNT + [SAMPLER_SHORT] * SAMPLER_COUNT
    strings, planted = planted_strings(rng, lengths, PATTERNS[0])
    data = smod.SamplerData([EncodedSequence.encode(s) for s in strings])

    def run(device):
        sampler = smod.Sampler(data, width=len(PATTERNS[0]),
                               rng=np.random.default_rng(SAMPLER_SEED), device=device)
        steps = []
        t0 = time.perf_counter()
        for _, it in zip(range(SAMPLER_STEPS), sampler):
            steps.append((it.z, tuple(sampler.starts), sampler.active.tobytes(),
                          sampler.motif.tobytes(), sampler.background_counts.tobytes()))
        torch.cuda.synchronize()
        return steps, (time.perf_counter() - t0) / SAMPLER_STEPS, sampler, it

    reset_launches()
    card, card_s, sampler, last = run(DEVICE)
    launches = launch_counts()
    host, host_s, _, _ = run("cpu")
    long_drawn = sum(len(data.sequences[z]) >= smod.DEVICE_THRESHOLD for z, *_ in card)
    if {k: v for k, v in launches.items() if v} != {"score_f32": long_drawn} or not long_drawn:
        raise SystemExit(f"sampler: launches {launches}, {long_drawn} long hold-outs drawn")
    bad = next((i for i, (a, b) in enumerate(zip(card, host)) if a != b), None)
    if bad is not None or len(card) != len(host):
        raise SystemExit(f"sampler: the card's trajectory leaves the CPU's at step {bad}")
    # K1 at the hold-outs' shape against its plain version and the host oracle
    z = next(z for z, *_ in reversed(card) if len(data.sequences[z]) >= smod.DEVICE_THRESHOLD)
    dseq = DeviceSequence(data.sequences[z], DEVICE)
    w = torch.from_numpy(np.ascontiguousarray(last.pssm.data)).to(DEVICE)
    n = len(data.sequences[z]) - len(last.pssm) + 1
    err = check_kernel("score_f32", kernels.score_f32, torch_ops.score_f32, dseq.data, w, n)
    got = kernels.score_f32(dseq.data, w, n)[:n].cpu().numpy()
    if not np.array_equal(got.view(np.uint32),
                          last.pssm.score_host(data.sequences[z]).view(np.uint32)):
        raise SystemExit("sampler: K1 != score_host at a hold-out")
    k1_ms = time_cuda(lambda: kernels.score_f32(dseq.data, w, n), repeat=20)
    plain_ms = time_cuda(lambda: torch_ops.score_f32(dseq.data, w, n))
    seq_cpu, w_cpu = dseq.data.cpu(), w.cpu()
    cpu_plain_ms = statistics.median(wall_ms(lambda: torch_ops.score_f32(seq_cpu, w_cpu, n)))
    shifts = np.asarray(sampler.starts) - planted
    log("sampler", sequences=f"{SAMPLER_COUNT}x{SAMPLER_LONG}+{SAMPLER_COUNT}x{SAMPLER_SHORT}",
        steps=SAMPLER_STEPS, identical_card_cpu=True, long_holdouts=long_drawn,
        launches=launches, k1_equal_plain_and_host=True, max_abs_err=err,
        card_s_per_step=f"{card_s:.5f}", cpu_s_per_step=f"{host_s:.5f}",
        holdout_windows=n, k1_ms=f"{k1_ms:.4f}", k1_plain_ms=f"{plain_ms:.4f}",
        k1_plain_host_cpu_ms=f"{cpu_plain_ms:.4f}",
        information_content=f"{last.pssm.information_content():.3f}",
        # sequences at the planted site, up to the most common shift
        at_planted_site=f"{max(np.mean(shifts == d) for d in range(-3, 4)):.3f}")
    return launches["score_f32"]


def peak_strings() -> list:
    """BATCH_SEQS seeded peak-like sequences of 100-500 bp, each with
    BATCH_MOTIF planted once."""
    rng = np.random.default_rng(BATCH_SEED)
    lengths = rng.integers(BATCH_LENGTHS[0], BATCH_LENGTHS[1] + 1, BATCH_SEQS)
    return planted_strings(rng, lengths, BATCH_MOTIF)[0]


def aligned(consensus: str, motif: str, max_shift: int = 2) -> int:
    """Most positions of ``consensus`` (case ignored) equal to ``motif``
    shifted by at most ``max_shift``."""
    consensus = consensus.upper()
    return max(sum(consensus[i] == motif[i + d] for i in range(len(consensus))
                   if 0 <= i + d < len(motif))
               for d in range(-max_shift, max_shift + 1))


def phase_batch_sampler() -> None:
    """The batched sampler on the card, OOPS and ZOOPS, 64 chains over the
    peak-like sequences: 100 steps and a resume of 100 must be
    bit-identical to one run of 200; a run of BATCH_RECOVERY_STEPS must
    recover the planted motif (its best chain's consensus, within a shift
    of 2)."""
    from lightmotif_tpu_torch import sampler_batch as bmod

    seqs = peak_strings()
    for mode, fn, kw in (("oops", bmod.sample_oops_batch, {}),
                         ("zoops", bmod.sample_zoops_batch, {"seeds": BATCH_ZOOPS_SEEDS})):
        common = dict(width=len(BATCH_MOTIF), chains=BATCH_CHAINS, seed=BATCH_SEED,
                      device=DEVICE, **kw)
        half = BATCH_STEPS // 2
        part = fn(seqs, steps=half, **common)
        rest = fn(seqs, steps=BATCH_STEPS - half, state=part.state, **common)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        full = fn(seqs, steps=BATCH_STEPS, **common)
        full_s = time.perf_counter() - t0
        same = (np.array_equal(rest.starts, full.starts) and np.array_equal(rest.active, full.active)
                and np.array_equal(rest.information_content.view(np.uint32),
                                   full.information_content.view(np.uint32))
                and torch.equal(rest.state.key, full.state.key))
        if not same:
            raise SystemExit(f"batch_sampler {mode}: {half} + {BATCH_STEPS - half} steps != "
                             f"{BATCH_STEPS} steps")
        t0 = time.perf_counter()
        rec = fn(seqs, steps=BATCH_RECOVERY_STEPS, **common)
        rec_s = time.perf_counter() - t0
        consensus = rec.count_matrix().consensus()
        if aligned(consensus, BATCH_MOTIF) < len(BATCH_MOTIF) - 2:
            raise SystemExit(f"batch_sampler {mode}: consensus {consensus} of "
                             f"{BATCH_RECOVERY_STEPS} steps, planted {BATCH_MOTIF}")
        log("batch_sampler", mode=mode, sequences=len(seqs), chains=BATCH_CHAINS,
            resume=f"{half}+{BATCH_STEPS - half} == {BATCH_STEPS} steps (bit-identical)",
            s_per_step=f"{full_s / BATCH_STEPS:.5f}",
            steps_per_s=f"{BATCH_STEPS / full_s:.1f}",
            recovery_steps=BATCH_RECOVERY_STEPS,
            recovery_s_per_step=f"{rec_s / BATCH_RECOVERY_STEPS:.5f}",
            consensus=consensus, planted=BATCH_MOTIF,
            best_ic=f"{float(rec.information_content[rec.best]):.3f}",
            best_active=int(rec.active[rec.best].sum()))


def mesh_k3_launches(sm) -> int:
    """K3 launches of one ``ShardedMultiScanner`` scan of the bound
    genome: one per motif group, shard and segment with a window of the
    group."""
    launches = 0
    for _, dseq in sm._bound.shards:
        scanner = sm._scanners[dseq.device]
        for g in scanner._groups:
            n_valid = int(np.maximum(dseq.length - sm.lengths[g["ids"]] + 1, 0).max())
            launches += -(-min(n_valid, sm._bound.chunk) // scanner.SEGMENT)
    return launches


def phase_mesh(pssm, seq, ms, scanner_hits, brute) -> dict:
    """The sharded scans at full width on MESH_SHARDS x the card and on
    the default mesh: ShardedScanner (MX000001, the genome, p = 1e-5)
    equal to the Scanner's hits; sharded_argmax equal to score_max, the
    known best hit winning its tie across shards; ShardedMultiScanner
    with the database equal to MultiScanner (K3 once per group and
    shard); the four long dense motifs of phase_other_paths through the
    mesh (K1 once per motif and shard).  The host reads of one call on 1
    and MESH_SHARDS shards (no more on MESH_SHARDS); the two steps of
    the sharded scan and the argmax's per-shard loop under the sync
    debug mode "error" (no read of the card between the shards); walls
    at 1, 2, 4 and 8 shards beside the single-device walls of the same
    call.  Returns the launches of each kernel."""
    from lightmotif_tpu_torch import DNA, Scanner
    from lightmotif_tpu_torch.ops.pipeline import PAD_MULTIPLE, Pipeline
    from lightmotif_tpu_torch.parallel import (ShardedMultiScanner, ShardedScanner,
                                               make_genome_mesh, sharded_argmax)
    from lightmotif_tpu_torch.parallel import mesh as mesh_mod
    from lightmotif_tpu_torch.scanner import MultiScanner

    total = {}

    def expect(what, launches, want):
        if {k: v for k, v in launches.items() if v} != want:
            raise SystemExit(f"mesh {what}: launches {launches}, expected {want}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    mesh = make_genome_mesh([DEVICE] * MESH_SHARDS)
    default = make_genome_mesh()
    t = pssm.score_distribution().score(1e-5)
    n = len(seq) - len(pssm) + 1
    genome = np.asarray(seq.data)

    reset_launches()
    sc = ShardedScanner(pssm, seq, threshold=t, mesh=mesh)
    hits = sc.collect()
    torch.cuda.synchronize()
    one_pssm = {"scan_segment": MESH_SHARDS + sc.reruns}
    expect("ShardedScanner.collect", launch_counts(), one_pssm)
    shard_hits = sc.shard_hits.tolist()
    pos = np.asarray([h.position for h in hits], np.int64)
    bits = np.asarray([f32_bits(h.score) for h in hits], np.uint32)
    if not (np.array_equal(pos, scanner_hits[0]) and np.array_equal(bits, scanner_hits[1])):
        raise SystemExit(f"mesh: ShardedScanner != Scanner ({len(hits)} vs {len(scanner_hits[0])})")
    reset_launches()
    reruns = sc.reruns
    best = sc.max()
    torch.cuda.synchronize()
    one_pssm = {"scan_segment": MESH_SHARDS + sc.reruns - reruns}
    expect("ShardedScanner.max", launch_counts(), one_pssm)
    if best.position != KNOWN_BEST_POS or f32_bits(best.score) != KNOWN_BEST_BITS:
        raise SystemExit(f"mesh: ShardedScanner.max {best}")
    log("mesh", check="ShardedScanner.collect == Scanner, max == the known best",
        shards=MESH_SHARDS, hits=len(hits), shard_hits=shard_hits)

    reset_launches()
    mx, am = sharded_argmax(pssm.data, genome, mesh=mesh)
    torch.cuda.synchronize()
    expect("sharded_argmax", launch_counts(), {"score_f32": MESH_SHARDS})
    chunk = mesh_mod._chunk_for(n, MESH_SHARDS, PAD_MULTIPLE)
    if am != KNOWN_BEST_POS or f32_bits(mx) != KNOWN_BEST_BITS:
        raise SystemExit(f"mesh: sharded_argmax ({mx}, {am})")
    if KNOWN_TIE_POS // chunk == KNOWN_BEST_POS // chunk:
        raise SystemExit("mesh: the tie does not cross shards")
    log("mesh", check="sharded_argmax == score_max", argmax=am, bits=hex(f32_bits(mx)),
        tie_at=KNOWN_TIE_POS, tie_shard=KNOWN_TIE_POS // chunk,
        best_shard=KNOWN_BEST_POS // chunk, chunk=chunk)

    mesh_no_reads(sc, t)

    want = ms.scan_arrays(seq)
    scanners = {}
    for label, devices in ((f"{MESH_SHARDS} x {DEVICE}", mesh), ("default", default)):
        reset_launches()
        t0 = time.perf_counter()
        sm = ShardedMultiScanner(ms.pssms, thresholds=ms.thresholds, mesh=devices)
        got = sm.scan_arrays(seq)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        expect(f"ShardedMultiScanner ({label})", launch_counts(),
               group_launches(mesh_k3_launches(sm)))
        check_scan(f"mesh ShardedMultiScanner ({label})", got, brute)
        if not same_hits(got, want):
            raise SystemExit(f"mesh ShardedMultiScanner ({label}) != MultiScanner")
        scanners[label] = sm
        log("mesh", check="ShardedMultiScanner.scan_arrays == MultiScanner == brute force",
            mesh=label, shards=len(devices), groups=len(sm._scanners[devices[0]]._groups),
            hits=len(got[0]),
            launches=launch_counts(), first_scan_s=f"{first_s:.3f}")

    # the issue of the database scan (every shard's steps, graph replays
    # in steady state) under the sync debug mode: no read of the card
    sm8 = scanners[f"{MESH_SHARDS} x {DEVICE}"]
    mesh_issue_no_reads(sm8, brute, "mesh")

    # the host reads of one call, on 1 and on MESH_SHARDS shards of the card
    reads = {}
    for shards in (1, MESH_SHARDS):
        one = make_genome_mesh([DEVICE] * shards)
        scanner = ShardedScanner(pssm, seq, threshold=t, mesh=one)
        scanner._prep()
        database = scanners[f"{MESH_SHARDS} x {DEVICE}"] if shards == MESH_SHARDS else (
            ShardedMultiScanner(ms.pssms, thresholds=ms.thresholds, mesh=one).bind(seq))
        for name, fn in (("ShardedScanner.collect", scanner.collect),
                         ("ShardedScanner.max", scanner.max),
                         ("sharded_argmax", lambda: sharded_argmax(pssm.data, genome, mesh=one)),
                         ("ShardedMultiScanner.collect_arrays", database.collect_arrays)):
            fn()  # warm
            torch.cuda.synchronize()
            mesh_mod.reset_host_reads()
            fn()
            reads.setdefault(name, {})[shards] = mesh_mod.HOST_READS
    for name, by_shards in reads.items():
        log("mesh", host_reads=name, **{f"shards_{k}": v for k, v in by_shards.items()})
        if by_shards[MESH_SHARDS] > by_shards[1]:
            raise SystemExit(f"mesh: {name} reads the card more on {MESH_SHARDS} shards: "
                             f"{by_shards}")
    if any(by_shards != {1: 1, MESH_SHARDS: 1} for by_shards in reads.values()):
        raise SystemExit(f"mesh: a steady call reads the card more than once: {reads}")
    ms.host_reads = 0
    ms.collect_arrays()
    log("mesh", host_reads="MultiScanner.collect_arrays", steady=ms.host_reads)
    if ms.host_reads != 1:
        raise SystemExit(f"mesh: MultiScanner.collect_arrays read {ms.host_reads} times")

    rng = np.random.default_rng(0xDE45E)  # phase_other_paths' dense motifs
    long = synthetic_motifs(rng, DNA, [129, 150, 200, 257])
    ths = [p.score_distribution().score(1e-5) for p in long]
    dense = ShardedMultiScanner(long, thresholds=ths, mesh=mesh)
    reset_launches()
    got = dense.scan_arrays(seq)
    torch.cuda.synchronize()
    expect("dense", launch_counts(), {"score_f32": len(long) * MESH_SHARDS})
    single = MultiScanner(long, thresholds=ths, device=DEVICE)
    if not (len(got[0]) and same_hits(got, single.scan_arrays(seq))):
        raise SystemExit("mesh: dense motifs != MultiScanner")
    log("mesh", check="dense motifs through the mesh == MultiScanner", motifs=len(long),
        shards=MESH_SHARDS, hits=len(got[0]))

    # walls of the same call, sharded and single-device, in turns
    pipe = Pipeline(DEVICE)
    single_scanner = Scanner(pssm, seq, threshold=t, device=DEVICE)
    pairs = []
    for shards in (1, 2, 4, 8):
        one = make_genome_mesh([DEVICE] * shards)
        scanner = ShardedScanner(pssm, seq, threshold=t, mesh=one)
        pairs += [
            (f"{shards} shards, ShardedScanner.collect / Scanner.collect", scanner.collect,
             single_scanner.collect),
            (f"{shards} shards, sharded_argmax (shard + upload) / Pipeline.score_max (upload)",
             functools.partial(sharded_argmax, pssm.data, genome, mesh=one),
             lambda: pipe.score_max(pssm, seq))]
    pairs += [
        (f"{MESH_SHARDS} shards, ShardedMultiScanner.collect_arrays / "
         f"MultiScanner.scan_arrays, {len(ms.pssms)} PSSMs",
         scanners[f"{MESH_SHARDS} x {DEVICE}"].collect_arrays, lambda: ms.scan_arrays(seq)),
        (f"{MESH_SHARDS} shards, dense ShardedMultiScanner.collect_arrays / "
         "MultiScanner.scan_arrays", dense.collect_arrays, lambda: single.scan_arrays(seq)),
    ]
    for op, sharded, one in pairs:
        sharded_ms, single_ms, runs = walls_in_turns(sharded, one)
        log("times", op=f"mesh walls on one card: {op}", sharded_ms=sharded_ms,
            single_ms=single_ms, runs=runs)
    # the 8-shard walls split: one profiled run each, the device's busy
    # time (its kernels) against the rest (host, profiler included)
    for op, sharded, one in pairs:
        if op.startswith(f"{MESH_SHARDS} shards") and "dense" not in op:
            (wall_a, busy_a), (wall_b, busy_b) = device_split(sharded), device_split(one)
            log("times", op=f"mesh split, one profiled run: {op}",
                sharded_wall_ms=f"{wall_a:.4f}", sharded_device_busy_ms=f"{busy_a:.4f}",
                single_wall_ms=f"{wall_b:.4f}", single_device_busy_ms=f"{busy_b:.4f}")
    return total


#: The range of a profiled run that :func:`trace_kernels` reads.
TIMED_RANGE = "chip_smoke.timed"


def event_name(e: dict) -> str:
    """A trace event's kernel name, arguments dropped."""
    name = e.get("name", "").replace("(anonymous namespace)::", "").removeprefix("void ")
    return name.split("(")[0][:90] or "unnamed"


def trace_kernels(prof, events=None) -> tuple:
    """The card's work in the recorded run of :func:`profiled`, from the
    trace's own device events (kernels, copies and sets on the current
    card, each with its start and duration) that start inside the
    :data:`TIMED_RANGE` range: the busy ms, the union of their intervals
    (so work on two streams at once counts once), the ms of each kernel
    name (arguments dropped, equal names summed), the largest first, and
    the number of events, inside the range and before it (the warm-up
    run's).  ``events``: the trace's, when the caller exported it."""
    events = trace_events(prof) if events is None else events
    card = torch.cuda.current_device()
    lo = min(float(e["ts"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == TIMED_RANGE)
    spans, by_name, before = [], {}, 0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        if e.get("args", {}).get("device", card) != card:
            continue
        t0, dur = float(e["ts"]), float(e.get("dur", 0.0))
        if t0 < lo:
            before += 1
            continue
        spans.append((t0, t0 + dur))
        name = event_name(e)
        by_name[name] = by_name.get(name, 0.0) + dur / 1e3
    busy_us, end = 0.0, None
    for t0, t1 in sorted(spans):
        if end is None or t0 > end:
            busy_us += t1 - t0
            end = t1
        elif t1 > end:
            busy_us += t1 - end
            end = t1
    return (busy_us / 1e3, sorted(by_name.items(), key=lambda kv: -kv[1]), len(spans),
            before)


def profiled(fn, timed=None, stack: bool = False) -> tuple:
    """Two runs under one ``torch.profiler`` session: ``fn`` as a warm-up
    (the tracer may miss the first kernels of a session), then ``timed``
    (default ``fn``), the recorded one, inside the :data:`TIMED_RANGE`
    range after every card has finished the warm-up.  ``stack`` also
    records the Python calls.  Returns ``(wall ms of the recorded run,
    profiler on, the profiler)``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    def sync_all():
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)

    sync_all()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 with_stack=stack) as prof:
        fn()
        sync_all()
        with record_function(TIMED_RANGE):
            t0 = time.perf_counter()
            (timed or fn)()
            sync_all()
            wall = (time.perf_counter() - t0) * 1e3
    return wall, prof


def trace_events(prof) -> list:
    """The chrome-trace events of a profiler (through a file of its own
    inside the checkout)."""
    import os
    import tempfile

    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f).get("traceEvents", [])


#: Host events of a trace, in the order :func:`card_split` paints them.
HOST_CATS = ("python_function", "cpu_op", "cuda_runtime", "cuda_driver")


def host_label(e) -> str:
    """A host event's name for :func:`card_split`: a Python call as
    ``file:function``, an op or a CUDA call by its name."""
    name = e.get("name", "")
    if e.get("cat") == "python_function" and "): " in name:
        path, fn = name.split("): ", 1)
        return f"{path.split('(')[0].rsplit('/', 1)[-1]}:{fn}"
    return name[:60]


def card_split(prof, cards) -> tuple:
    """Where each card's time went in the recorded run of a
    :func:`profiled` call over several cards, from its own trace.

    Per card: its busy ms (the union of its kernels, copies and sets),
    the start of its first and the end of its last (ms from the start of
    the run), and its idle ms in the run, with the host's state during
    that idle time by thread: what each thread was inside, its deepest
    traced event (a Python call where they are recorded, an op, a CUDA
    runtime call; "untraced" where a thread shows none), in ms, the
    largest first.  Per thread: its traced ms by the same labels.  The
    profiler records ops and Python calls on the thread that started it;
    CUDA runtime calls on every thread."""
    events = trace_events(prof)
    rng_ev = next(e for e in events
                  if e.get("cat") == "user_annotation" and e.get("name") == TIMED_RANGE)
    lo, hi = float(rng_ev["ts"]), float(rng_ev["ts"]) + float(rng_ev["dur"])
    main_tid = rng_ev.get("tid")
    n_bins = int(hi - lo) + 1  # microseconds

    def span(e):
        a = int(max(float(e["ts"]), lo) - lo)
        b = int(min(float(e["ts"]) + float(e.get("dur", 0.0)), hi) - lo) + 1
        return a, b

    busy = {c.index: np.zeros(n_bins, bool) for c in cards}
    threads, labels = {}, ["untraced"]
    for e in sorted((e for e in events if e.get("ph") == "X"),
                    key=lambda e: (float(e["ts"]), -float(e.get("dur", 0.0)))):
        if float(e["ts"]) + float(e.get("dur", 0.0)) < lo or float(e["ts"]) > hi:
            continue
        cat = e.get("cat")
        if cat in ("kernel", "gpu_memcpy", "gpu_memset"):
            dev = e.get("args", {}).get("device")
            if dev in busy:
                a, b = span(e)
                busy[dev][a:b] = True
        elif cat in HOST_CATS:
            tid = e.get("tid")
            if tid not in threads:
                threads[tid] = np.zeros(n_bins, np.int32)
            name = host_label(e)
            if name not in labels:
                labels.append(name)
            a, b = span(e)
            threads[tid][a:b] = labels.index(name)
    role = {tid: ("main" if tid == main_tid else f"thread{i}")
            for i, tid in enumerate(sorted(threads, key=lambda t: t != main_tid))}

    def top(mask, n=6):
        out = {}
        for tid, paint in threads.items():
            hist = np.bincount(paint[mask], minlength=len(labels))
            for i in np.argsort(-hist)[:n]:
                if hist[i]:
                    out[f"{role[tid]}:{labels[i]}"] = round(hist[i] / 1e3, 4)
        return dict(sorted(out.items(), key=lambda kv: -kv[1])[:n])

    per_card = []
    for c in cards:
        mask = busy[c.index]
        where = np.flatnonzero(mask)
        per_card.append({
            "card": c.index, "busy_ms": round(mask.sum() / 1e3, 4),
            "first_ms": round(where[0] / 1e3, 4) if where.size else None,
            "last_ms": round((where[-1] + 1) / 1e3, 4) if where.size else None,
            "idle_ms": round((~mask).sum() / 1e3, 4), "idle_host": top(~mask)})
    per_thread = {role[tid]: {"traced_ms": round((paint > 0).sum() / 1e3, 4),
                              "top": top_labels(paint, labels)}
                  for tid, paint in threads.items()}
    return round((hi - lo) / 1e3, 4), per_card, per_thread


def top_labels(paint, labels, n=6) -> dict:
    hist = np.bincount(paint[paint > 0], minlength=len(labels))
    return {labels[i]: round(hist[i] / 1e3, 4) for i in np.argsort(-hist)[:n] if hist[i]}


def device_split(fn) -> tuple:
    """One profiled run of ``fn`` (:func:`profiled`): its wall (ms,
    profiler on) and the card's busy time (ms, :func:`trace_kernels`)."""
    wall, prof = profiled(fn)
    return wall, trace_kernels(prof)[0]


def stage_split(scanners, fn) -> dict:
    """One profiled run of ``fn`` (:func:`profiled`) with the timing hook
    of every ``MultiScanner`` in ``scanners`` on (all on the current
    card): the ms of each stage by CUDA events (an interval counts to the
    stage that ends it, host gaps inside it included; "end" is what
    follows the last stage: reads, re-runs, the host's sorting), the
    counts each stage gave (read after the run), the run's wall, the
    card's busy time from the trace's device events (:func:`trace_kernels`)
    with the time of each kernel and the number of events, and the rest,
    the host's."""
    marks = []

    def mark(stage, n):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((stage, ev, n))

    def timed():
        for scanner in scanners:
            scanner.mark = mark
        try:
            mark("start", 0)
            fn()
            mark("end", 0)
        finally:
            for scanner in scanners:
                scanner.mark = None

    wall, prof = profiled(fn, timed)
    stages, counts = {}, {}
    for (_, a, _), (stage, b, _) in zip(marks, marks[1:]):
        stages[stage] = stages.get(stage, 0.0) + a.elapsed_time(b)
    for stage, _, n in marks[1:-1]:
        value = n.cpu().numpy() if torch.is_tensor(n) else np.asarray(n)
        counts[stage] = counts.get(stage, 0) + value.astype(np.int64)
    busy, kernels, n_events, n_warm = trace_kernels(prof)
    out = {f"{k}_ms": round(v, 4) for k, v in stages.items()}
    out["top_kernels_ms"] = {name: round(ms, 4) for name, ms in kernels[:10]}
    out.update({f"n_{k}": v.tolist() for k, v in counts.items()})
    out.update(wall_ms=round(wall, 4), device_events=n_events, warmup_events=n_warm,
               device_busy_ms=round(busy, 4) if busy else None,
               host_ms=round(wall - busy, 4) if busy else None,
               idle_share=round(1 - busy / wall, 4) if busy else None)
    return out


def walls_in_turns(sharded, single, runs: int = RUNS) -> tuple:
    """Median walls (ms) of two callables in turns (single, sharded,
    sharded, single), ``runs`` each: the lower median of each, and all
    four."""
    med = statistics.median
    a1, b1, b2, a2 = (wall_ms(fn, runs) for fn in (single, sharded, sharded, single))
    return (f"{min(med(b1), med(b2)):.4f}", f"{min(med(a1), med(a2)):.4f}",
            f"sharded={med(b1):.4f},{med(b2):.4f} single={med(a1):.4f},{med(a2):.4f}")


def mesh_no_reads(sc, t) -> None:
    """The loops over shards of the one-PSSM sharded scan (every shard's
    segment kernel, for ``collect`` and for ``max``) and of ``sharded_argmax``
    (K1 and the last-max reduction per shard, then the merge on each card
    and across the cards) under the sync debug mode "error", on every card
    of the scanner's mesh: any read of a card inside them raises.  The
    issued shards' hits (one read, :func:`kept_hits`) equal
    ``ShardedScanner``'s, their best (one read) the known best; a steady
    ``collect`` and ``max`` read once each (``HOST_READS``)."""
    from lightmotif_tpu_torch.ops import kernels, torch_ops
    from lightmotif_tpu_torch.parallel import mesh as mesh_mod
    from lightmotif_tpu_torch.scanner import best_hit, kept_hits, merge_best

    prepared, tables = sc._prep()
    shards, chunk, n_scores = prepared
    want = [(h.position, f32_bits(h.score)) for h in sc.collect()]
    sc.max()
    mesh_mod.reset_host_reads()
    sc.collect()
    sc.max()
    steady = mesh_mod.HOST_READS
    if steady != 2:
        raise SystemExit(f"mesh: a steady collect and max read the cards {steady} times")
    m, t_scaled = len(sc.pssm), sc.dm.scale(t)
    sync_all()
    try:
        torch.cuda.set_sync_debug_mode("error")
        segments = mesh_mod._issue_shards(tables, prepared, t_scaled, t, m, sc.cap)
        candidates = mesh_mod._issue_shards(tables, prepared, t_scaled, -np.inf, m, sc.cap)
        best = {}
        for d, shard in shards:
            n_local = mesh_mod._owned(n_scores, d, chunk)
            scores = kernels.score_f32(shard, tables[shard.device][0], n_local)[:n_local]
            best.setdefault(shard.device, []).append(
                (torch_ops.max_last(scores), torch_ops.argmax_last(scores) + d * chunk))
        merged = merge_best([pair for pairs in best.values() for pair in pairs])
    except RuntimeError as e:
        raise SystemExit(f"mesh: the card was read inside a loop over shards: {e}") from None
    finally:
        torch.cuda.set_sync_debug_mode("default")
    positions, scores, *_ = kept_hits(segments, sc.cap, {}, mesh_mod.multi.read_host)
    if [(int(p), f32_bits(v)) for p, v in zip(positions, scores)] != want:
        raise SystemExit("mesh: the shards issued under the sync debug mode != ShardedScanner")
    top, _, _ = best_hit(candidates, sc.cap, mesh_mod.multi.read_host)
    if [f32_bits(top[0]), top[1]] != [KNOWN_BEST_BITS, KNOWN_BEST_POS]:
        raise SystemExit(f"mesh: the issued candidates' best is {top}")
    if [f32_bits(merged[0].item()), int(merged[1])] != [KNOWN_BEST_BITS, KNOWN_BEST_POS]:
        raise SystemExit(f"mesh: the merge on the card gives {merged}")
    log("mesh", check="no read of a card inside the loops over shards (sync debug mode "
        "error): every shard's segment kernel (collect, max), K1 + argmax_last, the merge; a "
        "steady collect and max read once each", shards=len(shards), cards=len(best),
        cap=sc.cap, hits=len(want), steady_reads=steady)


def mesh_issue_no_reads(sm, brute, phase: str) -> None:
    """``ShardedMultiScanner._issue`` (every shard's steps on every device
    of its mesh) under the sync debug mode "error", after two scans (the
    second captures the graphs, so this one replays them): any read of a
    card inside it raises.  The issued entries' hits equal ``brute``."""
    from lightmotif_tpu_torch.ops import multi
    from lightmotif_tpu_torch.parallel import mesh as mesh_mod

    sm.collect_arrays()
    mesh_mod.reset_host_reads()
    sm.collect_arrays()
    if mesh_mod.HOST_READS != 1:
        raise SystemExit(f"{phase}: a steady collect_arrays read {mesh_mod.HOST_READS} times")
    sync_all()
    try:
        torch.cuda.set_sync_debug_mode("error")
        issued = sm._issue()
    except RuntimeError as e:
        raise SystemExit(f"{phase}: the database scan's issue read the card: {e}") from None
    finally:
        torch.cuda.set_sync_debug_mode("default")
    parts = [multi.collect_device(entries, state=sm._scanners[device]._group_state,
                                  hints=sm._scanners[device]._head_hint)
             for device, (entries, _) in issued.items()]
    check_scan(f"{phase}: the issue under the sync debug mode", multi.merge_hits(parts), brute)
    log(phase, check="a steady ShardedMultiScanner.collect_arrays reads once; its _issue (every "
        "shard's groups and stages on every card) reads nothing under the sync debug mode "
        "error", host_reads=1, shards=len(sm._bound.shards),
        devices=len(issued), replayed=all(g is not None for _, g in issued.values()),
        graphs={str(d): [s.replays.captured, s.replays.replayed]
                for d, s in sm._scanners.items()})


def dispatch_no_reads(scanner, seq, want, phase: str) -> None:
    """``MultiScanner.dispatch`` of the whole genome on the scanner's card
    under the sync debug mode "error", after two scans (eager, then the
    capture): no read of the card inside it; its hits equal ``want``."""
    scanner.bind(seq)
    scanner.collect_arrays()
    scanner.collect_arrays()
    sync_all()
    try:
        torch.cuda.set_sync_debug_mode("error")
        token = scanner.dispatch()
    except RuntimeError as e:
        raise SystemExit(f"{phase}: the dispatch on {scanner.device} read the card: {e}"
                         ) from None
    finally:
        torch.cuda.set_sync_debug_mode("default")
    scanner.host_reads = 0
    check_scan(f"{phase}: dispatched on {scanner.device} under the sync debug mode",
               scanner.fetch(token), want)
    if scanner.host_reads != 1 or not token["replayed"]:
        raise SystemExit(f"{phase}: on {scanner.device}: {scanner.host_reads} reads, "
                         f"replayed {token['replayed']}")
    log(phase, check="MultiScanner.dispatch reads nothing (sync debug mode error), its "
        "fetch reads once, every step a graph replay", device=str(scanner.device),
        graphs_captured=scanner.replays.captured, graphs_replayed=scanner.replays.replayed)


def sync_all() -> None:
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def phase_mesh_cards(pssm, seq, ms, scanner_hits, brute, counts=None) -> None:
    """With two or more cards: the default mesh over every card equal to
    the single-process hits (ShardedScanner, sharded_argmax,
    ShardedMultiScanner), and walls on 1..N cards, one shard per card,
    beside the single-device walls of the same call.  With one card, a
    log line says so."""
    from lightmotif_tpu_torch.parallel import ShardedMultiScanner, make_genome_mesh

    cards = make_genome_mesh()  # every card
    if len(cards) < 2:
        log("mesh", multi_card=f"not run, {len(cards)} device")
        return
    want = ms.scan_arrays(seq)
    walls = {}
    for k in range(1, len(cards) + 1):
        mesh = cards[:k]
        one_pssm_on_cards(pssm, seq, scanner_hits, mesh, walls)
        reset_launches()
        sm = ShardedMultiScanner(ms.pssms, thresholds=ms.thresholds, mesh=mesh)
        got = sm.scan_arrays(seq)
        for device in mesh:
            torch.cuda.synchronize(device)
        want_launches = group_launches(mesh_k3_launches(sm))
        if {name: launch_counts()[name] for name in want_launches} != want_launches:
            raise SystemExit(f"mesh_cards: {k} cards, launches {launch_counts()}, "
                             f"expected {want_launches}")
        check_scan(f"mesh_cards ShardedMultiScanner on {k} cards", got, brute)
        if not same_hits(got, want):
            raise SystemExit(f"mesh_cards: ShardedMultiScanner on {k} cards != MultiScanner")
        log("mesh_cards", check="ShardedMultiScanner == one card", cards=k,
            database_hits=len(got[0]), shard_hits=sm.shard_hits.tolist())
        # the sync debug checks on every card of this mesh
        mesh_issue_no_reads(sm, brute, "mesh_cards")
        if k == len(cards):
            for scanner in sm._scanners.values():
                dispatch_no_reads(scanner, seq, brute, "mesh_cards")
        op = "ShardedMultiScanner.collect_arrays / MultiScanner.scan_arrays"
        sharded_ms, single_ms, runs = walls_in_turns(sm.collect_arrays,
                                                     lambda: ms.scan_arrays(seq))
        walls.setdefault(op, {})[k] = float(sharded_ms)
        log("times", op=f"mesh walls on {k} cards, one shard each: {op}",
            sharded_ms=sharded_ms, single_ms=single_ms, runs=runs,
            positions_per_s=f"{len(seq) / float(sharded_ms) * 1e3:.4g}")
        # where each card's time goes in one steady collect_arrays: once
        # with the ops and CUDA calls alone, once with the Python calls too
        for stack in (False, True):
            wall, prof = profiled(sm.collect_arrays, stack=stack)
            run_ms, per_card, per_thread = card_split(prof, mesh)
            log("mesh_cards", split="ShardedMultiScanner.collect_arrays, one profiled run",
                cards=k, python_calls=stack, wall_ms=f"{wall:.4f}", run_ms=run_ms,
                per_card=json.dumps(per_card), per_thread=json.dumps(per_thread))
    log_scaling(walls)
    if counts is not None:
        cli_mesh_cards(seq, counts, brute, len(cards))


def log_scaling(walls: dict) -> None:
    """Each op's scaling over the cards: its 1-card wall over k times its
    k-card wall."""
    for op, by_k in walls.items():
        log("mesh_cards", scaling=op, **{f"cards_{k}": f"{by_k[1] / (k * w):.3f}"
                                         for k, w in by_k.items()})


def one_pssm_on_cards(pssm, seq, scanner_hits, mesh, walls: dict) -> None:
    """The one-PSSM sharded scans on ``mesh`` (cards, one shard each):
    ``ShardedScanner.collect`` and ``sharded_scan`` equal to the Scanner's
    hits, ``max`` and ``sharded_argmax`` the known best hit; every shard's
    segment kernel issued under the sync debug mode "error" on every card and
    one read a steady call (:func:`mesh_no_reads`); the wall of
    ``collect`` in turns with the same call on the first card alone,
    kept in ``walls``."""
    from lightmotif_tpu_torch.parallel import ShardedScanner, sharded_argmax, sharded_scan

    t = pssm.score_distribution().score(1e-5)
    k = len(mesh)
    sc = ShardedScanner(pssm, seq, threshold=t, mesh=mesh)
    hits = sc.collect()
    dm = pssm.to_discrete()
    pos, scores = sharded_scan(pssm.data, dm.data, np.asarray(seq.data), t, dm.scale(t),
                               mesh=mesh)
    for what, got in (("ShardedScanner", [(h.position, f32_bits(h.score)) for h in hits]),
                      ("sharded_scan", list(zip(pos.tolist(), map(f32_bits, scores))))):
        if got != list(zip(scanner_hits[0].tolist(), scanner_hits[1].tolist())):
            raise SystemExit(f"mesh_cards: {what} on {k} cards != Scanner")
    best = sc.max()
    mx, am = sharded_argmax(pssm.data, np.asarray(seq.data), mesh=mesh)
    if [best.position, f32_bits(best.score), am, f32_bits(mx)] != [
            KNOWN_BEST_POS, KNOWN_BEST_BITS, KNOWN_BEST_POS, KNOWN_BEST_BITS]:
        raise SystemExit(f"mesh_cards: {k} cards, max {best}, argmax ({mx}, {am})")
    log("mesh_cards", check="ShardedScanner, sharded_scan, max, sharded_argmax == one card",
        cards=k, hits=len(hits), cap=sc.cap, reruns=sc.reruns)
    mesh_no_reads(sc, t)
    on_first = ShardedScanner(pssm, seq, threshold=t, mesh=mesh[:1])
    op = "ShardedScanner.collect / ShardedScanner.collect on the first card"
    sharded_ms, single_ms, runs = walls_in_turns(sc.collect, on_first.collect)
    walls.setdefault(op, {})[k] = float(sharded_ms)
    log("times", op=f"mesh walls on {k} cards, one shard each: {op}", sharded_ms=sharded_ms,
        single_ms=single_ms, runs=runs,
        positions_per_s=f"{len(seq) / float(sharded_ms) * 1e3:.4g}")


def one_pssm_cards(parent: str | None = None) -> int:
    """The one-PSSM sharded scans alone on every card
    (:func:`one_pssm_on_cards` on 1..N cards), with what they are held to
    (the build, the Scanner's hits), and with ``parent`` the one-PSSM
    walls of both checkouts in turns (:func:`phase_parent`)."""
    from lightmotif_tpu_torch.parallel import make_genome_mesh

    phase_card()
    phase_build()
    pssm, seq = build_inputs()
    _, scanner_hits = phase_main_path(pssm, seq)
    cards = make_genome_mesh()
    walls = {}
    for k in range(1, len(cards) + 1):
        one_pssm_on_cards(pssm, seq, scanner_hits, cards[:k], walls)
    log_scaling(walls)
    if parent is not None:
        phase_parent(parent, one_pssm=True)
    print(json.dumps({"ok": True, "one_pssm_cards": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def cli_mesh_cards(seq, counts, brute, n_cards: int) -> None:
    """The CLI's ``--mesh`` database x genome run (in this process) on
    every card beside the same run on the first card alone
    (``use_device``), in turns (one, every, every, one): equal TSVs, the
    walls."""
    import os
    import tempfile

    from lightmotif_tpu_torch.ops.pipeline import use_device

    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as work:
        db_file, genome_fa = os.path.join(work, "db.jaspar"), os.path.join(work, "genome.fa")
        write_jaspar16(db_file, counts, "DB")
        write_fasta(genome_fa, [("genome", seq)])
        args = ["-m", db_file, "--format", "jaspar16", "-s", genome_fa, "-P", str(DB_PVALUE),
                "--reverse", "--mesh"]
        walls, tsvs = {1: [], n_cards: []}, set()
        for k in (1, n_cards, n_cards, 1):
            out = os.path.join(work, f"mesh{k}.tsv")
            use_device("cuda:0" if k == 1 else None)
            try:
                _, wall, _ = run_cli([*args, "-o", out], f"database x genome --mesh, {k} cards")
            finally:
                use_device(None)
            walls[k].append(wall)
            tsvs.add(open(out).read())
    if len(tsvs) != 1:
        raise SystemExit("mesh_cards: the CLI's --mesh TSV on one card != on every card")
    log("mesh_cards", op="cli database x genome --mesh, in process, in turns",
        rows=next(iter(tsvs)).count("\n") - 1, one_card_s=f"{min(walls[1]):.3f}",
        cards=n_cards, every_card_s=f"{min(walls[n_cards]):.3f}",
        runs=f"one={','.join(f'{w:.3f}' for w in walls[1])} "
        f"every={','.join(f'{w:.3f}' for w in walls[n_cards])}")


MESH_WORKER = """
import json, os, statistics, subprocess, sys, threading, time
import numpy as np
import torch
import torch.distributed as dist

rank, world, backend, port, out, card, shards, fresh = sys.argv[1:]
rank, world, card, shards = int(rank), int(world), int(card), int(shards)
torch.cuda.set_device(card)
dist.init_process_group(backend, init_method="tcp://localhost:" + port, world_size=world,
                        rank=rank)
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from lightmotif_tpu_torch.ops import build, kernels
from lightmotif_tpu_torch.parallel import (ShardedMultiScanner, ShardedScanner,
                                           make_genome_mesh, sharded_argmax)
from lightmotif_tpu_torch.parallel import mesh as mesh_mod

device = torch.device("cuda", card)
nvcc = []
if fresh == "1":
    # two threads reach the first launch at once, the build directory
    # empty: one build (one nvcc per source), both results equal
    real = build.subprocess.Popen
    build.subprocess.Popen = lambda args, **kw: nvcc.append(args[0]) or real(args, **kw)
    seq_t = torch.randint(0, 4, (1 << 16,), dtype=torch.uint8, device=device)
    table = torch.randn(15, 5, device=device)
    results = [None, None]
    def first(i):
        results[i] = kernels.score_f32(seq_t, table, (1 << 16) - 14)
    threads = [threading.Thread(target=first, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    build.subprocess.Popen = real
    nvcc.append(bool(torch.equal(results[0], results[1])))
pssm, seq = cs.build_inputs()
pssms, ths, _ = cs.synthetic_database(cs.DB_MOTIFS, cs.DB_SEED)
mesh = make_genome_mesh([device] * shards)
t = pssm.score_distribution().score(1e-5)
from lightmotif_tpu_torch.ops import multi
launches, reads, reruns = {}, {}, {}
def run(name, fn):
    cs.reset_launches()
    mesh_mod.reset_host_reads()
    value = fn()
    torch.cuda.synchronize()
    launches[name], reads[name] = cs.launch_counts(), mesh_mod.HOST_READS
    reruns[name] = dict(multi.RERUNS)
    return value
scanner = ShardedScanner(pssm, seq, threshold=t, mesh=mesh)
hits = run("collect", scanner.collect)
shard_hits = scanner.shard_hits
best = run("max", scanner.max)
mx, am = run("argmax", lambda: sharded_argmax(pssm.data, np.asarray(seq.data), mesh=mesh))
sm = ShardedMultiScanner(pssms, thresholds=ths, mesh=mesh)
mo, pos, sc = run("database", lambda: sm.scan_arrays(seq))
walls = {}  # the ranks start each run together; the exchange ends it together
for name, fn in (("ShardedScanner.collect", scanner.collect),
                 ("ShardedMultiScanner.collect_arrays", sm.collect_arrays)):
    times = []
    for _ in range(cs.RUNS + 1):
        dist.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    walls[name] = statistics.median(times[1:])
# the database scan's split by stage on this rank, one profiled run
split = cs.stage_split(list(sm._scanners.values()), sm.collect_arrays)
np.savez(out, pos=np.asarray([h.position for h in hits], np.int64),
         bits=np.asarray([cs.f32_bits(h.score) for h in hits], np.uint32),
         argmax=np.asarray([cs.f32_bits(mx), am], np.int64),
         max=np.asarray([cs.f32_bits(best.score), best.position], np.int64),
         mo=mo, mpos=pos, msc=sc, shard_hits=shard_hits, multi_shard_hits=sm.shard_hits,
         k3=cs.mesh_k3_launches(sm), runs=json.dumps({"launches": launches, "reads": reads,
                                                      "nvcc": nvcc, "walls": walls,
                                                      "reruns": reruns, "split": split}),
         jax=np.asarray(sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "lightmotif_tpu"))))
dist.destroy_process_group()
"""


def run_ranks(label: str, backend: str, cards: list, shards_each: int,
              scanner_hits, brute, fresh_build: bool = False) -> dict:
    """One process per entry of ``cards`` (its CUDA device), joined with
    ``torch.distributed`` over ``backend``, each owning ``shards_each``
    shards: over the genome (ShardedScanner, its max, sharded_argmax)
    and the database (ShardedMultiScanner).  Their merged hits must
    equal the single-process hits, every rank must report the known best
    hit and the same per-shard counts, and each path must launch its
    kernel once per shard (K3, phase C and the pairs kernel once per
    group and shard, and once per re-run).  With ``fresh_build`` the
    first rank starts from an empty build directory and launches from two
    threads at once: one build.  Logs every rank's walls and its database
    scan's split by stage; returns the walls (ms, the slowest rank's
    median) of ``ShardedScanner.collect`` and
    ``ShardedMultiScanner.collect_arrays``, each run started on every
    rank at once."""
    import os
    import shutil
    import socket
    import tempfile

    root = os.path.dirname(os.path.abspath(__file__))
    work = tempfile.mkdtemp(prefix="chip-smoke-mesh-")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    outs = [os.path.join(work, f"rank{r}.npz") for r in range(len(cards))]
    t0 = time.perf_counter()
    procs = []
    for r, card in enumerate(cards):
        fresh = fresh_build and r == 0
        rank_env = dict(env, LIGHTMOTIF_TPU_COMPILE_CACHE=os.path.join(work, "build")) \
            if fresh else env
        procs.append(subprocess.Popen(
            [sys.executable, "-c", MESH_WORKER, str(r), str(len(cards)), backend, port,
             outs[r], str(card), str(shards_each), "1" if fresh else "0"],
            cwd=root, env=rank_env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    try:
        for r, p in enumerate(procs):
            text, _ = p.communicate(timeout=600)
            if p.returncode != 0:
                raise SystemExit(f"{label}: rank {r} exit {p.returncode}\n{text[-4000:]}")
        wall = time.perf_counter() - t0
        res = [dict(np.load(o)) for o in outs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    runs = [json.loads(str(r["runs"])) for r in res]
    pos = np.concatenate([r["pos"] for r in res])
    bits = np.concatenate([r["bits"] for r in res])
    order = np.argsort(pos, kind="stable")
    if not (np.array_equal(pos[order], scanner_hits[0])
            and np.array_equal(bits[order], scanner_hits[1])):
        raise SystemExit(f"{label}: the merged ShardedScanner hits != Scanner")
    known = [KNOWN_BEST_BITS, KNOWN_BEST_POS]
    for r in res:
        if r["argmax"].tolist() != known or r["max"].tolist() != known or r["jax"].size:
            raise SystemExit(f"{label}: argmax {r['argmax'].tolist()}, max "
                             f"{r['max'].tolist()}, jax {r['jax']}")
    for key in ("shard_hits", "multi_shard_hits"):
        if any(not np.array_equal(res[0][key], r[key]) for r in res):
            raise SystemExit(f"{label}: the ranks' {key} differ")
    mo = np.concatenate([r["mo"] for r in res])
    mpos = np.concatenate([r["mpos"] for r in res])
    msc = np.concatenate([r["msc"] for r in res])
    order = np.lexsort((mpos, mo))
    check_scan(f"{label} ShardedMultiScanner", (mo[order], mpos[order], msc[order]), brute)
    from lightmotif_tpu_torch.ops.multi_stages import PAIRS_KERNELS

    for r, run in zip(res, runs):
        k3 = int(r["k3"]) + run["reruns"]["database"]["group"]
        one_pssm = {"scan_segment": shards_each}
        want = {"collect": one_pssm, "max": one_pssm,
                "argmax": {"score_f32": shards_each},
                "database": {"prefilter_any8": k3, "phase_c_bits": k3,
                             "pairs_rescore": k3 * PAIRS_KERNELS}}
        got = {name: {k: v for k, v in counts.items() if v}
               for name, counts in run["launches"].items()}
        if got != want:
            raise SystemExit(f"{label}: launches {got}, expected {want}")
    from lightmotif_tpu_torch.ops import build

    n_sources = len(build.PRODUCTION_SOURCES)
    if fresh_build and runs[0]["nvcc"] != [runs[0]["nvcc"][0]] * n_sources + [True]:
        raise SystemExit(f"{label}: the first launch from two threads: {runs[0]['nvcc']}")
    walls = {name: max(run["walls"][name] for run in runs) for name in runs[0]["walls"]}
    log(label, processes=len(cards), backend=backend, cards=cards, shards_each=shards_each,
        scanner_hits=[len(r["pos"]) for r in res], database_hits=[len(r["mo"]) for r in res],
        merged_equal_single=True, argmax=KNOWN_BEST_POS, shard_hits=res[0]["shard_hits"].tolist(),
        launches=[run["launches"] for run in runs], host_reads=[run["reads"] for run in runs],
        reruns=[run["reruns"]["database"] for run in runs],
        **({"first_build": "2 threads, one nvcc per source, equal results"}
           if fresh_build else {}),
        slowest_walls_ms={k: f"{v:.4f}" for k, v in walls.items()}, wall_s=f"{wall:.3f}")
    # every rank's walls and its database scan's split by stage
    for rank, run in enumerate(runs):
        log(label, rank=rank, card=cards[rank],
            walls_ms={k: f"{v:.4f}" for k, v in run["walls"].items()},
            database_split=json.dumps(run["split"]))
    return walls


def phase_mesh_procs(scanner_hits, brute) -> None:
    """The process exchange: two gloo processes sharing the card, four
    shards each; one NCCL process of MESH_SHARDS shards (the collective
    runs with one rank), whose kernels build from an empty directory
    under two threads; with two or more cards, two NCCL processes of
    four shards, one card each, then 1, 2 and N NCCL processes of one
    shard and one card each: the walls across processes and their
    scaling efficiency (the 1-process wall over k times the k-process
    wall)."""
    run_ranks("mesh_procs", "gloo", [0, 0], MESH_SHARDS // 2, scanner_hits, brute)
    run_ranks("mesh_nccl", "nccl", [0], MESH_SHARDS, scanner_hits, brute, fresh_build=True)
    cards = torch.cuda.device_count()
    if cards < 2:
        log("mesh_nccl", multi_card=f"not run, {cards} device")
        return
    run_ranks("mesh_nccl", "nccl", [0, 1], MESH_SHARDS // 2, scanner_hits, brute)
    walls = {k: run_ranks("mesh_nccl_walls", "nccl", list(range(k)), 1, scanner_hits, brute)
             for k in sorted({1, 2, cards})}
    for op in walls[1]:
        log("mesh_nccl_walls", scaling=op, **{
            f"ranks_{k}": f"{walls[1][op] / (k * w[op]):.3f}" for k, w in walls.items()})


def bound(nbytes: float, ops: float, kind: str) -> tuple:
    """The least time the card could take for a function (ms) and what
    bounds it: the bytes it must move (each input read once, each output
    written once) over HBM's rate, or its operations over the card's
    peak for their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def prefilter_bound(seq, planes, chunk_m, t_eff) -> tuple:
    """A prefilter's bound on this run's inputs: the int8 tensor-core form
    of its sums (one-hot windows x its byte planes, 2 operations per
    multiply-add) over the rows each lane chunk needs (``chunk_m``),
    against one byte in and four out per position and its planes."""
    from lightmotif_tpu_torch.ops import multi_kernel

    lp, n_planes, k = seq.shape[0], planes.shape[0], planes.shape[4]
    nbytes = 5 * lp + planes.nbytes + chunk_m.nbytes + t_eff.nbytes
    ops = 2 * n_planes * lp * k * multi_kernel.K3_LANES * int(chunk_m.sum())
    return bound(nbytes, ops, "int8")


def windows_onehot(seq, k: int, m: int, rows: int = 64):
    """The sequence as f32 one-hot rows ``[rows, K, T + m - 1]`` of T
    window starts each plus their halo (the wildcard past the end), so
    a convolution's output stays within 32-bit indexing per row."""
    import torch.nn.functional as F

    lp = seq.shape[0]
    t = -(-lp // rows)
    ext = torch.full((rows * t + m - 1,), k - 1, dtype=torch.long, device=seq.device)
    ext[:lp] = seq.long().clamp(max=k - 1)
    idx = torch.arange(rows, device=seq.device)[:, None] * t + torch.arange(
        t + m - 1, device=seq.device)
    return F.one_hot(ext[idx], k).permute(0, 2, 1).float().contiguous()


def library_ms(fn, check) -> tuple:
    """The median ms of one library computation (``torch.nn.functional.
    conv1d`` and what completes it) in full f32 (TF32 off), and whether
    ``check`` finds its result equal to the kernel's."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        torch.cuda.empty_cache()
        equal = check(fn())
        ms = time_cuda(fn, runs=3)
    finally:
        torch.backends.cudnn.allow_tf32 = saved
        torch.cuda.empty_cache()
    return ms, equal


def library_prefilter(seq, planes, t_eff, got) -> tuple:
    """A prefilter as PyTorch computes it: ``conv1d`` of the one-hot
    sequence with every lane's cells as a filter and ``-t_eff`` as the
    bias, then ``amax`` over the lanes (two calls)."""
    import torch.nn.functional as F

    from lightmotif_tpu_torch.ops import torch_ops

    cells = torch_ops.plane_cells(planes)  # [lanes, rows, K]
    m, k = cells.shape[1], cells.shape[2]
    x = windows_onehot(seq, k, m)
    weight = cells.permute(0, 2, 1).float().contiguous()
    bias = -t_eff.float()
    n = seq.shape[0] - m + 1
    fn = lambda: F.conv1d(x, weight, bias).amax(dim=1)  # noqa: E731
    return library_ms(fn, lambda out: bool(torch.equal(
        out.reshape(-1)[:n], got[:n].float())))


def time_cuda(fn, repeat: int = 1, runs: int = RUNS) -> float:
    """Median milliseconds of one ``fn()`` over ``runs`` samples after a
    warm-up, timed with CUDA events around ``repeat`` calls.

    With ``repeat > 1`` the calls queue up behind a GPU spin, so the
    events time the device work alone and not the host's launch cost
    (which is larger than a genome-sized scoring kernel).
    """
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if repeat > 1:
            torch.cuda._sleep(50_000_000)  # about 25 ms at 2 GHz
        start.record()
        for _ in range(repeat):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / repeat)
    return statistics.median(times)


def launch_earlier(seq, table, n_scores):
    """K1 through the per-call host work of the earlier wrapper (the library
    lookup, a ctypes call for the tile size, the shared-memory arithmetic,
    the device context and the stream lookup), for the host-cost
    comparison; the launch itself is the same."""
    from lightmotif_tpu_torch.ops import build, kernels

    kernels._check(seq, table, torch.float32, n_scores)
    if not (seq.is_contiguous() and table.is_contiguous()):
        raise ValueError("seq and table must be contiguous")
    lib = build.probe_library()
    m, k = table.shape
    smem = m * k * 4 + lib.lm_score_variants() + m - 1
    if smem > kernels._MAX_SMEM:
        raise ValueError("table too large")
    lp = seq.shape[0]
    out = torch.empty(lp, dtype=torch.float32, device=seq.device)
    with torch.cuda.device(seq.device):
        stream = torch.cuda.current_stream(seq.device).cuda_stream
        err = getattr(lib, "lm_score_f32")(seq.data_ptr(), lp, table.data_ptr(), m, k,
                                           n_scores, out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"launch failed: {err}")
    return out


def host_us(fn, calls: int = 400) -> float:
    """Median host microseconds of one ``fn()`` (the enqueue, no
    synchronisation) over 5 runs of ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(5):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        runs.append((time.perf_counter() - t0) / calls * 1e6)
        torch.cuda.synchronize()
    return statistics.median(runs)


def phase_host_cost(pssm, seq) -> None:
    """The host's part of one ``kernels.score_f32`` call beside its device
    time: this wrapper and the earlier one's per-call work, in turns
    (earlier, now, now, earlier), each the median enqueue time of 400
    calls."""
    from lightmotif_tpu_torch.ops import kernels
    from lightmotif_tpu_torch.ops.pipeline import DeviceSequence

    dseq = DeviceSequence(seq, DEVICE)
    n = len(seq) - len(pssm) + 1
    w = torch.from_numpy(pssm.data).to(DEVICE)
    if not torch.equal(launch_earlier(dseq.data, w, n), kernels.score_f32(dseq.data, w, n)):
        raise SystemExit("host cost: the two wrappers disagree")
    a1 = host_us(lambda: launch_earlier(dseq.data, w, n))
    b1 = host_us(lambda: kernels.score_f32(dseq.data, w, n))
    b2 = host_us(lambda: kernels.score_f32(dseq.data, w, n))
    a2 = host_us(lambda: launch_earlier(dseq.data, w, n))
    device_ms = time_cuda(lambda: kernels.score_f32(dseq.data, w, n), repeat=20)
    log("host", op="kernels.score_f32 host part per call (enqueue, median of 400)",
        now_us=f"{min(b1, b2):.2f}", earlier_wrapper_us=f"{min(a1, a2):.2f}",
        runs_us=f"earlier={a1:.2f},{a2:.2f} now={b1:.2f},{b2:.2f}",
        device_us=f"{device_ms * 1e3:.2f}")


def phase_times(pssm, seq) -> dict:
    import torch.nn.functional as F

    from lightmotif_tpu_torch import Scanner
    from lightmotif_tpu_torch.ops import kernels, torch_ops
    from lightmotif_tpu_torch.ops.pipeline import DeviceSequence, Pipeline

    dseq = DeviceSequence(seq, DEVICE)
    n = len(seq) - len(pssm) + 1
    w = torch.from_numpy(pssm.data).to(DEVICE)
    d = torch.from_numpy(pssm.to_discrete().data).to(DEVICE)
    out = {}
    x = windows_onehot(dseq.data, d.shape[1], len(pssm))
    # conv1d of the one-hot genome, which reassociates the f32 sum; the
    # -inf wildcard cells become -1e4 (0 x -inf would make every window
    # NaN), which changes no window of the genome, which has no wildcard
    w_lib = torch.where(torch.isfinite(w), w, -1e4).t()[None].contiguous()
    libraries = {
        "score_f32": lambda: F.conv1d(x, w_lib),
        "score_u8": lambda: F.conv1d(x, d.t().float()[None]).clamp_(max=255),
    }
    for name, kernel, plain, table in (
            ("score_f32", kernels.score_f32, torch_ops.score_f32, w),
            ("score_u8", kernels.score_u8, torch_ops.score_u8, d)):
        # device time per launch, in turns: plain, kernel, kernel, plain
        p1 = time_cuda(lambda: plain(dseq.data, table, n), repeat=20)
        k1 = time_cuda(lambda: kernel(dseq.data, table, n), repeat=20)
        k2 = time_cuda(lambda: kernel(dseq.data, table, n), repeat=20)
        p2 = time_cuda(lambda: plain(dseq.data, table, n), repeat=20)
        ms, plain_ms = min(k1, k2), min(p1, p2)
        # one call as a caller sees it, host launch cost included
        call_ms = time_cuda(lambda: kernel(dseq.data, table, n))
        plain_call_ms = time_cuda(lambda: plain(dseq.data, table, n))
        # bytes: the padded genome in, 4 bytes out per position, the table;
        # operations: one add per window row, at the f32 CUDA-core rate
        lp = dseq.data.shape[0]
        bound_ms, bound_by = bound(5 * lp + table.nbytes, n * len(pssm), "f32")
        got = kernel(dseq.data, table, n)[:n]
        lib_ms, lib_equal = library_ms(libraries[name], lambda o: float(
            (o.reshape(-1)[:n] - got.float()).abs().max()))
        out[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                     "bound_by": bound_by, "library_ms": lib_ms}
        log("times", kernel=name, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            gpos_s=f"{n / ms / 1e6:.3f}", plain_gpos_s=f"{n / plain_ms / 1e6:.3f}",
            runs=f"k={k1:.4f},{k2:.4f} p={p1:.4f},{p2:.4f}",
            call_ms=f"{call_ms:.4f}", plain_call_ms=f"{plain_call_ms:.4f}",
            bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
            library_ms=f"{lib_ms:.4f}", library="conv1d of the one-hot genome"
            + (" + clamp" if name == "score_u8" else ""),
            library_max_abs_diff=lib_equal)

    pipe = Pipeline(DEVICE)
    ms = time_cuda(lambda: pipe.score_max(pssm, dseq))
    log("times", op="Pipeline.score_max (resident sequence)", ms=f"{ms:.4f}")
    ms = time_cuda(lambda: pipe.score_max(pssm, seq))
    log("times", op="Pipeline.score_max (with upload)", ms=f"{ms:.4f}")

    t = pssm.score_distribution().score(1e-5)
    walls = []
    for _ in range(RUNS + 1):
        t0 = time.perf_counter()
        Scanner(pssm, seq, threshold=t, device=DEVICE).collect()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    log("times", op="Scanner(...).collect() wall, p=1e-5",
        ms=f"{statistics.median(walls[1:]):.4f}")
    shapes = segment_shapes(pssm, seq, chromosome())
    out["scan_segment"] = time_scan_segment(shapes)["genome"]
    del shapes
    scanner = Scanner(pssm, dseq, threshold=t, device=DEVICE)
    log("times", op="Scanner.collect() wall, steady, resident sequence, p=1e-5",
        **wall_stats(wall_ms(scanner.collect)))
    t_scaled = int(scanner.dm.scale(t))
    log("times", op="Scanner._hits wall (the hit arrays, no Hit objects), steady",
        **wall_stats(wall_ms(lambda: scanner._hits(t_scaled, t))))
    log("times", op="Scanner.collect(), one profiled steady run",
        **steady_profile(scanner.collect))
    return out


def time_scan_segment(shapes) -> dict:
    """The segment kernel at each of :func:`segment_shapes` beside its
    plain version, device time per launch in turns (plain, kernel, kernel,
    plain) behind a GPU spin, and its bound on this run's data: the
    segment's n + m - 1 bytes and the two tables read once, the counters,
    the best and the kept hits written once; or its operations, m integer
    adds a window start and m f32 adds a rescored candidate (the first
    ``cap``), at the CUDA cores' f32 rate.  No single PyTorch call
    computes it (library none).  A call launches it once (its memset is
    not counted).  Returns ``{label: row}``."""
    from lightmotif_tpu_torch.ops import kernels, torch_ops

    out = {}
    for label, chunk, n, d, w, t_scaled, t, cap in shapes:
        args = (chunk, n, d, w, t_scaled, t, cap)
        counts = kernels.scan_segment(*args)[0].tolist()
        p1 = time_cuda(lambda: torch_ops.scan_segment(*args), repeat=20)
        k1 = time_cuda(lambda: kernels.scan_segment(*args), repeat=20)
        k2 = time_cuda(lambda: kernels.scan_segment(*args), repeat=20)
        p2 = time_cuda(lambda: torch_ops.scan_segment(*args), repeat=20)
        ms, plain_ms = min(k1, k2), min(p1, p2)
        call_ms = time_cuda(lambda: kernels.scan_segment(*args))
        m = d.shape[0]
        nbytes = chunk.shape[0] + d.nbytes + w.nbytes + 12 + 8 + 8 * counts[1]
        bound_ms, bound_by = bound(nbytes, m * n + m * min(counts[0], cap), "f32")
        log("times", kernel="scan_segment", shape=f"{label}, {n} window starts",
            candidates=counts[0], kept=counts[1], cap=cap, ms=f"{ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", runs=f"k={k1:.4f},{k2:.4f} p={p1:.4f},{p2:.4f}",
            call_ms=f"{call_ms:.4f}", bound_ms=f"{bound_ms:.4f}", bound_by=bound_by,
            bound_share=f"{bound_ms / ms:.3f}", launches_a_call=1, library="none")
        out[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                      "bound_by": bound_by, "library_ms": None}
    return out


def phase_database_times(ms, seq) -> tuple:
    """K3 at a database group's shape beside its plain version, the
    database scan's steady-state wall beside the plain stages' wall on
    the card (in turns), and its split by stage."""
    from lightmotif_tpu_torch.ops import multi_kernel, torch_ops

    dseq = ms._dseq
    group = ms._groups[0]
    n_valid = np.maximum(dseq.length - ms.lengths + 1, 0)
    chunk = dseq.data[: int(n_valid[group["ids"]].max()) + group["m_max"] - 1]
    args = group["k3"]
    kernel = lambda: multi_kernel.prefilter_any8(chunk, *args)  # noqa: E731
    plain = lambda: torch_ops.prefilter_any8(chunk, *args)  # noqa: E731
    n = chunk.shape[0] - group["m_max"] + 1
    if not torch.equal(kernel()[:n], plain()[:n]):
        raise SystemExit("prefilter_any8 != plain at the database group's shape")
    lanes = group["phase_c"][2].shape[0]
    # device time per launch, in turns: plain, kernel, kernel, plain
    p1 = time_cuda(plain, runs=3)
    k1 = time_cuda(kernel, repeat=3)
    k2 = time_cuda(kernel, repeat=3)
    p2 = time_cuda(plain, runs=3)
    ms_k3, plain_k3 = min(k1, k2), min(p1, p2)
    bound_ms, bound_by = prefilter_bound(chunk, *args)
    lib_ms, lib_equal = library_prefilter(chunk, args[0], args[2], kernel())
    entry = {"ms": ms_k3, "plain_ms": plain_k3, "bound_ms": bound_ms,
             "bound_by": bound_by, "library_ms": lib_ms}
    log("times", kernel="prefilter_any8", shape=f"{chunk.shape[0]}x{lanes} lanes, "
        f"m={group['m_max']}", equal=True, ms=f"{ms_k3:.4f}", plain_ms=f"{plain_k3:.4f}",
        runs=f"k={k1:.4f},{k2:.4f} p={p1:.4f},{p2:.4f}",
        gpos_lanes_s=f"{chunk.shape[0] * lanes / ms_k3 / 1e6:.3f}",
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by, library_ms=f"{lib_ms:.4f}",
        library="conv1d + amax", library_equal=lib_equal)

    # the scan's steady-state wall beside the plain stages' on the card, in
    # turns (plain, kernels, kernels, plain)
    plain = lambda: plain_stages_scan(ms)  # noqa: E731
    if not same_hits(plain(), ms.scan_arrays(seq)):
        raise SystemExit("database: the plain stages' hits != scan_arrays'")
    p1, k1 = wall_ms(plain, runs=5), wall_ms(lambda: ms.scan_arrays(seq))
    k2, p2 = wall_ms(lambda: ms.scan_arrays(seq)), wall_ms(plain, runs=5)
    med = statistics.median
    walls = k1 + k2
    wall = min(med(k1), med(k2))
    log("times", op=f"MultiScanner.scan_arrays wall, steady state, {len(ms.pssms)} PSSMs",
        ms=f"{wall:.4f}", p90_ms=f"{sorted(walls)[int(0.9 * len(walls))]:.4f}",
        pssm_gpos_s=f"{len(ms.pssms) * len(seq) / wall / 1e6:.3f}",
        plain_stages_ms=f"{min(med(p1), med(p2)):.4f}",
        runs=f"kernels={med(k1):.4f},{med(k2):.4f} plain={med(p1):.4f},{med(p2):.4f}",
        plain_stages="K3, then phase_c_bits_plain and pairs_rescore_plain at room for "
        "every pair")

    # split by stage (the scanner's timing hook records a CUDA event as
    # each stage's work is queued, so the stages run eagerly) in one
    # profiled run
    log("times", op="database scan by stage (one profiled run, CUDA events)",
        **stage_split([ms], lambda: ms.scan_arrays(seq)))
    # the steady path itself (graph replays, no hook): busy, host, idle
    before = (ms.replays.captured, ms.replays.replayed)
    wall, prof = profiled(lambda: ms.scan_arrays(seq))
    busy, kernels, n_events, _ = trace_kernels(prof)
    log("database", op="MultiScanner.scan_arrays, steady (graph replays), one profiled run",
        wall_ms=f"{wall:.4f}", device_busy_ms=f"{busy:.4f}", host_ms=f"{wall - busy:.4f}",
        idle_share=f"{1 - busy / wall:.4f}", device_events=n_events,
        eager_design_host_ms=3.0467, eager_design_idle_share=0.181,  # PERF.md section 5
        graphs_captured=ms.replays.captured - before[0],
        graphs_replayed=ms.replays.replayed - before[1],
        top_kernels_ms={name: round(v, 4) for name, v in kernels[:6]})
    return entry


def plain_stages_scan(ms):
    """The database scan of a ``MultiScanner``'s bound sequence through
    the plain versions of the exact stages on the card: each group's K3
    (the kernel), every candidate, ``phase_c_bits_plain`` and
    ``pairs_rescore_plain`` at room for every pair, each group and segment
    reading the card in between; hits sorted as ``scan_arrays`` sorts."""
    from lightmotif_tpu_torch.ops import multi, multi_stages

    dseq = ms._dseq
    if ms._route()["dense_idx"].size:
        raise SystemExit("the plain stages' scan takes no dense motif")
    parts = []
    for group in ms._groups:
        chunk, lanes, maxv = stage_inputs(group, dseq, ms.lengths)
        cand, count = multi.compact_candidates(maxv, max(int((maxv >= 0).sum()), 1))
        bits = multi_stages.phase_c_bits_plain(chunk, cand, count, *group["phase_c"], lanes)
        cap_hits = max(int(torch_popcount(bits)), 1)
        while True:
            counts, packed = multi_stages.pairs_rescore_plain(
                bits, cand, count, chunk, group["pssm"], group["th"], cap_hits)
            if int(counts[1]) <= cap_hits:
                break
            cap_hits = int(counts[1])
        kept = packed[:, : int(counts[2])]
        parts.append((kept[0].to(torch.int64), group["ids_dev"][kept[1].to(torch.int64)],
                      kept[2].view(torch.float32)))
    return multi.sorted_hits(parts)


def torch_popcount(words: torch.Tensor) -> torch.Tensor:
    """The set bits of an int32 tensor, summed."""
    shifts = torch.arange(32, device=words.device, dtype=torch.int32)
    return ((words[..., None] >> shifts) & 1).sum()


# -- the exact stages of another checkout, for timings in turns ---------------

class ParentBuild:
    """The production kernels of another checkout of this repository
    (``--parent DIR``, e.g. a ``git archive`` of the parent commit):
    ``prefilter.cu``, ``phase_c.cu`` and ``pairs.cu`` built from DIR's
    sources with the port's nvcc flags, all at once, into a temporary
    directory, for their SASS and ``ptxas -v`` lines."""

    SOURCES = ("prefilter", "phase_c", "pairs")

    def __init__(self, root: str, sources: tuple = SOURCES):
        import os
        import tempfile

        from lightmotif_tpu_torch.ops import build

        self.root = os.path.abspath(root)
        self.dir = tempfile.mkdtemp(prefix="chip-smoke-parent-")
        csrc = os.path.join(self.root, "lightmotif_tpu_torch", "ops", "csrc")
        jobs = []
        for name in sources:
            out = os.path.join(self.dir, f"lib{name}.so")
            jobs.append((name, out, subprocess.Popen(
                [build._nvcc(), *build.NVCC_FLAGS, "-o", out,
                 os.path.join(csrc, f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        self.log, self.paths = "", {}
        for name, out, proc in jobs:
            text = proc.communicate()[0]
            if proc.returncode != 0:
                raise SystemExit(f"parent: nvcc failed on {out}\n{text[-4000:]}")
            self.log += text
            self.paths[name] = out


class ParentScan:
    """The parent checkout's one-PSSM segment scan as its wrapper launched
    it: K2 (``lm_score_u8`` of its ``score.cu``) into an int32 buffer of
    scores, then C3 (``lm_scan_compact`` of its ``scan.cu``, three kernels),
    built from the checkout at ``root`` (:class:`ParentBuild`) and loaded
    with ctypes, so that both time in one process beside this tree's
    kernel."""

    def __init__(self, root: str):
        import ctypes

        self.build = ParentBuild(root, ("score", "scan"))
        i64, ptr, i32, f32 = ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.score = ctypes.CDLL(self.build.paths["score"])
        self.scan = ctypes.CDLL(self.build.paths["scan"])
        for fn, args, res in (
                (self.score.lm_score_u8, [ptr, i64, ptr, i32, i32, i64, ptr, ptr], i32),
                (self.scan.lm_scan_scratch, [i64], i64),
                (self.scan.lm_scan_compact,
                 [ptr, ptr, ptr, i32, i32, i64, i32, f32, i64, ptr, ptr, ptr, ptr], i32)):
            fn.argtypes, fn.restype = args, res

    @staticmethod
    def _stream(t):
        return torch._C._cuda_getCurrentRawStream(t.device.index)

    def k2(self, chunk, dm, n: int):
        m, k = dm.shape
        out = torch.empty(chunk.shape[0], dtype=torch.int32, device=chunk.device)
        err = self.score.lm_score_u8(chunk.data_ptr(), chunk.shape[0], dm.data_ptr(), m, k, n,
                                     out.data_ptr(), self._stream(chunk))
        if err:
            raise SystemExit(f"parent K2: CUDA error {err}")
        return out

    def c3(self, scores, chunk, w, n: int, t_scaled: int, t: float, cap: int):
        m, k = w.shape
        counts = torch.empty(3, dtype=torch.int32, device=chunk.device)
        packed = torch.empty((2, cap), dtype=torch.int32, device=chunk.device)
        scratch = torch.empty(self.scan.lm_scan_scratch(n), dtype=torch.uint8,
                              device=chunk.device)
        err = self.scan.lm_scan_compact(
            scores.data_ptr(), chunk.data_ptr(), w.data_ptr(), m, k, n, int(t_scaled),
            float(np.float32(t)), cap, scratch.data_ptr(), counts.data_ptr(), packed.data_ptr(),
            self._stream(chunk))
        if err:
            raise SystemExit(f"parent C3: CUDA error {err}")
        return counts, packed

    def segment(self, chunk, n, dm, w, t_scaled, t, cap):
        return self.c3(self.k2(chunk, dm, n), chunk, w, n, t_scaled, t, cap)


def segment_shapes(pssm, seq, chrom) -> list:
    """The one-PSSM segment scan's timed shapes, MX000001 at p = 1e-5 and
    the seed capacity: the genome as one segment, and the first full
    segment of ``DEFAULT_SEGMENT`` window starts of the chromosome
    stand-in ``chrom``.  Each ``(label, chunk, n, dm, w, t_scaled, t,
    cap)``, the tensors on the card."""
    from lightmotif_tpu_torch.scanner import DEFAULT_CAPACITY, DEFAULT_SEGMENT

    m = len(pssm)
    dm = pssm.to_discrete()
    t = pssm.score_distribution().score(1e-5)
    d = torch.from_numpy(np.ascontiguousarray(dm.data, np.uint8)).to(DEVICE)
    w = torch.from_numpy(np.ascontiguousarray(pssm.data, np.float32)).to(DEVICE)
    out = []
    for label, data in (("genome", seq.data),
                        (f"chromosome segment of {DEFAULT_SEGMENT}",
                         chrom.data[: DEFAULT_SEGMENT + m - 1])):
        chunk = torch.from_numpy(np.ascontiguousarray(data, np.uint8)).to(DEVICE)
        out.append((label, chunk, chunk.shape[0] - m + 1, d, w, int(dm.scale(t)), t,
                    DEFAULT_CAPACITY))
    return out


def time_parent_segment(parent: "ParentScan", shapes) -> None:
    """The parent's K2 + C3 at each of :func:`segment_shapes` in turns with
    this tree's segment kernel (parent, change, change, parent), device
    time per segment behind a GPU spin, their counters and kept hits
    equal; also the parent's K2 and C3 alone."""
    from lightmotif_tpu_torch.ops import kernels

    for label, chunk, n, d, w, t_scaled, t, cap in shapes:
        args = (chunk, n, d, w, t_scaled, t, cap)
        counts, packed = parent.segment(*args)
        got = kernels.scan_segment(*args)
        n_kept = int(counts[1])
        if not (torch.equal(got[0], counts) and torch.equal(got[1][:, :n_kept],
                                                            packed[:, :n_kept])):
            raise SystemExit(f"parent segment {label}: this tree's scan differs from the "
                             f"parent's ({got[0].tolist()} against {counts.tolist()})")
        fns = {"parent": lambda: parent.segment(*args),
               "change": lambda: kernels.scan_segment(*args)}
        runs = {"parent": [], "change": []}
        for who in ("parent", "change", "change", "parent"):
            runs[who].append(time_cuda(fns[who], repeat=20))
        scores = parent.k2(chunk, d, n)
        k2_ms = time_cuda(lambda: parent.k2(chunk, d, n), repeat=20)
        c3_ms = time_cuda(lambda: parent.c3(scores, chunk, w, n, t_scaled, t, cap), repeat=20)
        log("parent_segment", shape=label, starts=n, candidates=int(counts[0]), kept=n_kept,
            parent_k2_c3_ms=f"{min(runs['parent']):.4f}", parent_k2_ms=f"{k2_ms:.4f}",
            parent_c3_ms=f"{c3_ms:.4f}", ms=f"{min(runs['change']):.4f}", runs=" ".join(
                f"{who}={','.join(f'{v:.4f}' for v in vs)}" for who, vs in runs.items()))


def kernels_by_name(fn) -> dict:
    """One profiled steady run of ``fn`` (:func:`profiled`): every kernel
    name's launches and device ms in the recorded run, from the trace's
    own events, beside the run's wall and busy ms."""
    wall, prof = profiled(fn)
    events = trace_events(prof)
    busy, by_name, n_events, _ = trace_kernels(prof, events)
    lo = min(float(e["ts"]) for e in events
             if e.get("cat") == "user_annotation" and e.get("name") == TIMED_RANGE)
    counts = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "kernel" and float(e["ts"]) >= lo:
            counts[event_name(e)] = counts.get(event_name(e), 0) + 1
    return {"wall_ms": round(wall, 4), "device_busy_ms": round(busy, 4),
            "device_events": n_events, "kernels": json.dumps(
                {k: [counts.get(k, 0), round(v, 4)] for k, v in by_name})}


def segment_times(parent: str | None) -> int:
    """The one-PSSM segment scan alone: the build, the segment kernel's
    SASS, its checks against its plain version (:func:`phase_scan_segment`)
    and the main path on the genome (:func:`phase_main_path`), then at
    :func:`segment_shapes` this tree's kernel beside its plain version
    (:func:`time_scan_segment`) and, with ``parent``, beside the parent's
    K2 + C3 in turns
    (:func:`time_parent_segment`); then MX000001 on the chromosome
    (:func:`scale_single`: ``score_max``, ``Scanner.collect()``, the dense
    thresholds) and the launches and device ms of every kernel name in one
    profiled steady ``Scanner.collect()`` there (:func:`kernels_by_name`)."""
    from lightmotif_tpu_torch import Scanner
    from lightmotif_tpu_torch.ops import build
    from lightmotif_tpu_torch.ops.pipeline import DeviceSequence

    phase_card()
    build.library()
    scan_sass()
    pssm, seq = build_inputs()
    phase_scan_segment(pssm, seq)
    phase_main_path(pssm, seq)
    chrom = chromosome()
    shapes = segment_shapes(pssm, seq, chrom)
    time_scan_segment(shapes)
    if parent is not None:
        time_parent_segment(ParentScan(parent), shapes)
    del shapes
    settle()
    scale_single(pssm, chrom, sweep=False)
    dseq = DeviceSequence(chrom, DEVICE)
    scanner = Scanner(pssm, dseq, threshold=pssm.score_distribution().score(1e-5))
    scanner.collect()
    log("segment_times", profile="one steady Scanner.collect() on the chromosome, every "
        "kernel name: [launches, device ms]", **kernels_by_name(scanner.collect))
    print(json.dumps({"ok": True, "segment_times": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def ptxas_lines(log: str, names) -> list:
    """The ``ptxas -v`` lines (registers, spills, shared memory) of the
    kernels whose mangled names contain one of ``names``."""
    out, keep = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            keep = any(n in line for n in names)
        if keep and ("entry function" in line or "registers" in line or "spill" in line
                     or "stack frame" in line):
            out.append(line.strip())
    return out


WALLS_CHILD = r"""
import json, sys
import torch
import chip_smoke as cs
from lightmotif_tpu_torch.parallel import ShardedMultiScanner, make_genome_mesh
from lightmotif_tpu_torch.scanner import MultiScanner
torch.cuda.set_device(0)
pssm, seq = cs.build_inputs()
cards = make_genome_mesh()
out = {"hits": 0}
if sys.argv[1:] != ["one_pssm"]:
    pssms, ths, _ = cs.synthetic_database(cs.DB_MOTIFS, cs.DB_SEED)
    ms = MultiScanner(pssms, thresholds=ths, device=cs.DEVICE)
    out["hits"] = hits = len(ms.scan_arrays(seq)[0])
    out["scan_arrays"] = cs.wall_ms(lambda: ms.scan_arrays(seq))
    runs = [("8_shards", [cs.DEVICE] * 8)]
    runs += [(f"{k}_cards", cards[:k]) for k in range(1, len(cards) + 1)]
    for name, mesh in runs:
        sm = ShardedMultiScanner(pssms, thresholds=ths, mesh=mesh).bind(seq)
        if len(sm.collect_arrays()[0]) != hits:
            sys.exit(f"{name}: hits differ")
        out[name] = cs.wall_ms(sm.collect_arrays)
# the one-PSSM paths: MX000001 at p = 1e-5
from lightmotif_tpu_torch.batch import BatchScanner
from lightmotif_tpu_torch.ops.pipeline import DeviceSequence
from lightmotif_tpu_torch.parallel import ShardedScanner
from lightmotif_tpu_torch.scanner import Scanner
t = pssm.score_distribution().score(1e-5)
scanner = Scanner(pssm, DeviceSequence(seq, cs.DEVICE), threshold=t, device=cs.DEVICE)
one = len(scanner.collect())
out["one_pssm_hits"] = one
out["Scanner.collect"] = cs.wall_ms(scanner.collect)
bs = BatchScanner(pssm, cs.genome_records(seq), threshold=t, device=cs.DEVICE)
bs.collect()
out["BatchScanner.collect"] = cs.wall_ms(bs.collect)
for name, mesh in [("8 shards", [cs.DEVICE] * 8)] + [
        (f"{k} cards", cards[:k]) for k in range(1, len(cards) + 1)]:
    sc = ShardedScanner(pssm, seq, threshold=t, mesh=mesh)
    if len(sc.collect()) != one:
        sys.exit(f"ShardedScanner {name}: hits differ")
    out[f"ShardedScanner.collect, {name}"] = cs.wall_ms(sc.collect)
chromosome = cs.scale_genomes()[1][1]
scanner = Scanner(pssm, DeviceSequence(chromosome, cs.DEVICE), threshold=t, device=cs.DEVICE)
out["chromosome_hits"] = len(scanner.collect())
out["Scanner.collect, chromosome"] = cs.wall_ms(scanner.collect, cs.SCALE_RUNS)
print(json.dumps(out))
"""


def parent_walls(root: str, cache: str, one_pssm: bool = False) -> dict:
    """The steady walls (ms) of the checkout at ``root``, in a process of
    its own that imports that checkout's package and ``chip_smoke`` (the
    same seeded genome and database), building into ``cache``: the
    database's ``scan_arrays`` on the first card, its
    ``ShardedMultiScanner.collect_arrays`` on 8 shards of the first card
    and on 1..N cards, one shard each; MX000001 at p = 1e-5: a resident
    ``Scanner.collect()`` on the genome and on the chromosome,
    ``BatchScanner.collect`` over the genome's records, and
    ``ShardedScanner.collect`` on 8 shards and on 1..N cards.  With
    ``one_pssm``, the MX000001 walls alone."""
    import os

    proc = subprocess.run(
        [sys.executable, "-c", WALLS_CHILD, *(["one_pssm"] if one_pssm else [])], cwd=root,
        capture_output=True, text=True, timeout=900,
        env=dict(os.environ, PYTHONPATH=root, LIGHTMOTIF_TPU_COMPILE_CACHE=cache))
    if proc.returncode != 0:
        raise SystemExit(f"walls of {root} failed\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.splitlines()[-1])


def phase_parent(root: str, one_pssm: bool = False) -> None:
    """This tree beside the parent checkout at ``root``: the tensor-core
    instructions (``IMMA``) of every instantiation of the prefilter and
    of phase C equal, the pairs library's ``FADD`` and ``FFMA`` counts
    equal, the ``ptxas -v`` lines of both; the parent's K2 + C3 beside
    this tree's segment kernel in turns (:func:`time_parent_segment`); then
    the steady walls of both checkouts (:func:`parent_walls`), each in
    processes of its own, in turns (parent, change, change, parent): the
    database's ``scan_arrays``, 8 shards on one card, and 1..N cards, and
    MX000001's one-PSSM walls.  With ``one_pssm``, only the one-PSSM walls
    (no build of the parent's libraries, no database)."""
    import os
    import shutil
    import tempfile

    if not one_pssm:
        parent_sass(root)
        pssm, seq = build_inputs()
        time_parent_segment(ParentScan(root), segment_shapes(pssm, seq, chromosome()))
        settle()
    caches = {who: tempfile.mkdtemp(prefix=f"chip-smoke-{who}-") for who in ("parent", "change")}
    here_root = os.path.dirname(os.path.abspath(__file__))
    walls = functools.partial(parent_walls, one_pssm=one_pssm)
    try:
        runs = [walls(root, caches["parent"]), walls(here_root, caches["change"]),
                walls(here_root, caches["change"]), walls(root, caches["parent"])]
    finally:
        for path in caches.values():
            shutil.rmtree(path, ignore_errors=True)
    counted = ("hits", "one_pssm_hits", "chromosome_hits")
    if any(len({r[k] for r in runs}) != 1 for k in counted):
        raise SystemExit(f"parent: scan hits differ: {[[r[k] for k in counted] for r in runs]}")
    med = statistics.median
    for op in (k for k in runs[0] if k not in counted):
        a = [med(runs[0][op]), med(runs[3][op])]
        b = [med(runs[1][op]), med(runs[2][op])]
        log("parent", op=f"{op} wall, steady, own process each, in turns", hits=runs[0]["hits"],
            parent_ms=f"{min(a):.4f}", ms=f"{min(b):.4f}",
            runs=f"p:{a[0]:.4f},{a[1]:.4f}/c:{b[0]:.4f},{b[1]:.4f}")
    def best(who, op):
        return min(med(runs[i][op]) for i in who)

    for op in (k for k in runs[1] if k[0].isdigit()):
        log("parent", op=f"{op} / scan_arrays of the same checkout",
            ratio=f"{best((1, 2), op) / best((1, 2), 'scan_arrays'):.3f}",
            parent_ratio=f"{best((0, 3), op) / best((0, 3), 'scan_arrays'):.3f}")


def parent_sass(root: str) -> None:
    """The parent's prefilter, phase C and pairs libraries built from the
    checkout at ``root``: their tensor-core (``IMMA``) counts, and the
    pairs library's ``FADD`` and ``FFMA`` counts, equal to this tree's,
    with the ``ptxas -v`` lines of both."""
    import re
    import shutil

    from lightmotif_tpu_torch.ops import build

    def unhashed(counts: dict) -> dict:
        # an anonymous namespace's mangled name carries a hash of its source
        return {re.sub(r"_GLOBAL__N__[0-9a-f]+_", "", name): n for name, n in counts.items()}

    parent = ParentBuild(root)
    here = {p.name.split("-")[1]: p for p in build.build_info()["paths"]}
    for name in ("prefilter", "phase_c"):
        old, new = (unhashed(sass_mma_counts(path)) for path in (parent.paths[name],
                                                                  here[name]))
        if old != new or not new:
            raise SystemExit(f"parent: the IMMA counts of {name}.cu changed: {old} -> {new}")
        log("parent", source=f"{name}.cu", imma_unchanged=True, kernels=len(new),
            imma=sum(new.values()))
    old, new = sass_opcodes(parent.paths["pairs"]), sass_opcodes(here["pairs"])
    counts = {op: tuple(sum(ops.count(op) for ops in lib.values()) for lib in (old, new))
              for op in ("FADD", "FFMA")}
    if any(a != b for a, b in counts.values()):
        raise SystemExit(f"parent: the pairs library's FADD / FFMA changed: {counts}")
    log("parent", source="pairs.cu", fadd_ffma_unchanged=counts)
    for line in ptxas_lines(parent.log, ("phase_c_kernel", "row_offsets", "keep_pairs")):
        log("parent", ptxas=line)
    for line in ptxas_lines(build.build_info()["log"], ("phase_c_kernel", "row_offsets",
                                                        "keep_pairs")):
        log("change", ptxas=line)
    shutil.rmtree(parent.dir, ignore_errors=True)


def time_prefilter(name, seq, args, m, what: str) -> dict:
    """A prefilter kernel beside its plain version (in turns: plain,
    kernel, kernel, plain), its bound and its library computation."""
    from lightmotif_tpu_torch.ops import multi_kernel, torch_ops

    kernel = lambda: getattr(multi_kernel, name)(seq, *args)  # noqa: E731
    plain = lambda: getattr(torch_ops, name)(seq, *args)  # noqa: E731
    n = seq.shape[0] - m + 1
    got = kernel()
    if not torch.equal(got[:n], plain()[:n]):
        raise SystemExit(f"{name} != plain at {what}")
    p1 = time_cuda(plain, runs=3)
    k1 = time_cuda(kernel, repeat=3)
    k2 = time_cuda(kernel, repeat=3)
    p2 = time_cuda(plain, runs=3)
    ms, plain_ms = min(k1, k2), min(p1, p2)
    bound_ms, bound_by = prefilter_bound(seq, *args)
    lib_ms, lib_equal = library_prefilter(seq, args[0], args[2], got)
    lanes = args[2].shape[0]
    log("times", kernel=name, shape=what, equal=True, ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", runs=f"k={k1:.4f},{k2:.4f} p={p1:.4f},{p2:.4f}",
        gpos_lanes_s=f"{seq.shape[0] * lanes / ms / 1e6:.3f}",
        bound_ms=f"{bound_ms:.4f}", bound_by=bound_by, library_ms=f"{lib_ms:.4f}",
        library="conv1d + amax", library_equal=lib_equal)
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": lib_ms}


def wall_ms(fn, runs: int = RUNS) -> list:
    """Host-clock walls (ms) of ``fn()`` to a synchronised end, after one
    warm-up call."""
    walls = []
    for _ in range(runs + 1):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    return walls[1:]


def phase_mode_times(ms, seq, db, groups5) -> dict:
    """K4 at bench.py's shape and K5 at group 0's shape, each beside its
    plain version; the u16-mode and K3-mode database walls, in turns."""
    out = {}
    data, table, m = bench_k4_inputs(seq)
    out["prefilter_any"] = time_prefilter(
        "prefilter_any", data, table, m,
        f"bench: {data.shape[0]}x{BENCH_K4_LANES} lanes, m={m}")
    dseq = db.dseq
    group = groups5[0]
    n_valid = np.maximum(dseq.length - ms.lengths + 1, 0)
    chunk = dseq.data[: int(n_valid[group["ids"]].max()) + group["m_max"] - 1]
    lanes = group["phase_c"][2].shape[0]
    out["prefilter_any16"] = time_prefilter(
        "prefilter_any16", chunk, group["k5"], group["m_max"],
        f"database group 0: {chunk.shape[0]}x{lanes} lanes, m={group['m_max']}")

    segment = len(seq)
    k3a = wall_ms(lambda: ms.scan_arrays(seq))
    u16a = wall_ms(lambda: db.scan(groups5, segment))
    u16b = wall_ms(lambda: db.scan(groups5, segment))
    k3b = wall_ms(lambda: ms.scan_arrays(seq))
    med = statistics.median
    log("times", op=f"database scan wall, steady state, {len(ms.pssms)} PSSMs, "
        "median of 15 in turns (K3, u16, u16, K3)",
        k3_mode_ms=f"{med(k3a):.4f},{med(k3b):.4f}",
        u16_mode_ms=f"{med(u16a):.4f},{med(u16b):.4f}",
        k3_mode_p90_ms=f"{sorted(k3a + k3b)[int(0.9 * 2 * RUNS)]:.4f}",
        u16_mode_p90_ms=f"{sorted(u16a + u16b)[int(0.9 * 2 * RUNS)]:.4f}")
    return out


def phase_batch_times(pssm, records, br, mbs) -> None:
    """Steady-state walls of the batched records: BatchReducer (rebind +
    argmax) beside a per-record ``Pipeline.score_max`` loop, BatchScanner
    (collect, with its reads) and MultiBatchScanner (prepare + rebind +
    collect_arrays)."""
    from lightmotif_tpu_torch.ops.pipeline import Pipeline

    med = statistics.median
    reducer = wall_ms(lambda: br.rebind(records).argmax())
    pipe = Pipeline(DEVICE)
    m = len(pssm)
    per_record = wall_ms(lambda: [pipe.score_max(pssm, r) for r in records if len(r) >= m],
                         runs=3)
    log("times", op=f"BatchReducer rebind+argmax wall, {len(records)} records",
        ms=f"{med(reducer):.4f}", p90_ms=f"{sorted(reducer)[int(0.9 * RUNS)]:.4f}",
        per_record_score_max_ms=f"{med(per_record):.4f}")
    from lightmotif_tpu_torch.batch import BatchScanner

    t = pssm.score_distribution().score(1e-5)
    bs = BatchScanner(pssm, records, threshold=t, device=DEVICE)
    walls = wall_ms(bs.collect)
    bs._scanner.host_reads = 0
    bs.collect()
    log("times", op=f"BatchScanner.collect wall, steady, {len(records)} records, p=1e-5",
        ms=f"{med(walls):.4f}", p90_ms=f"{sorted(walls)[int(0.9 * RUNS)]:.4f}",
        steady_reads=bs._scanner.host_reads)
    multi = wall_ms(lambda: mbs.rebind_prepared(mbs.prepare(records)).collect_arrays())
    log("times", op=f"MultiBatchScanner prepare+rebind+collect_arrays wall, "
        f"{len(records)} records x {len(mbs.pssms)} PSSMs",
        ms=f"{med(multi):.4f}", p90_ms=f"{sorted(multi)[int(0.9 * RUNS)]:.4f}")


def phase_probes(ms, seq, times) -> dict:
    """P6, P7, P8 and P10 (``lightmotif_tpu_torch.probes.prefilter``): each
    probe kernel checked once against its plain version (``torch.equal``)
    with its launches counted from 0 around that check, then timed.  P7
    runs at database group 0 (K3's shape), P8 and P10 at K4's bench shape,
    whose bound, plain and library times (measured earlier in this run on
    the same inputs) they share; P8 and P10 also sweep group 0.  Returns
    the ``kernels`` entries of the probes."""
    from lightmotif_tpu_torch.probes import prefilter as probes

    group = ms._groups[0]
    n_valid = np.maximum(ms._dseq.length - ms.lengths + 1, 0)
    chunk = ms._dseq.data[: int(n_valid[group["ids"]].max()) + group["m_max"] - 1]
    data, table, m = bench_k4_inputs(seq)
    filt, x = (torch.from_numpy(a).to(DEVICE) for a in probes.mma_inputs(P6_POSITIONS))

    def checked(what, fn, want):
        probes.reset_launches()
        got = fn()
        torch.cuda.synchronize()
        launches = dict(probes.LAUNCHES)
        if not torch.equal(got, want):
            raise SystemExit(f"{what}: probe kernel != plain")
        return launches

    from lightmotif_tpu_torch.ops import torch_ops

    launches = {}
    want = probes.mma_max_plain(filt, x)
    for kind in ("u8", "bf16"):
        launches[f"probe_mma_{kind}"] = checked(
            f"P6 {kind}", lambda: probes.mma_max(filt, x, kind), want)[f"probe_mma_{kind}"]
    table7 = probes.lookup_table(group["k3"][0])
    launches["prefilter_lookup"] = checked(
        "P7", lambda: probes.prefilter_lookup(chunk, table7, *group["k3"][1:]),
        torch_ops.prefilter_any8(chunk, *group["k3"]))["prefilter_lookup"]
    want = torch_ops.prefilter_any8(data, *table)
    for orient in ("m", "n"):
        n_launched = 0
        for v, row in enumerate(probes.VARIANTS):
            if row[0] == orient:
                n_launched += checked(f"variant {v}",
                                      lambda: probes.prefilter_variant(v, data, *table),
                                      want)["prefilter_variant"]
        launches[f"prefilter_variant_{orient}"] = n_launched

    p6 = probes.run_p6(filt, x)
    for row in p6:
        log("probes", **{k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in row.items()})
    p7 = probes.run_p7(chunk, *group["k3"])
    log("probes", **{k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in p7.items()})
    sweeps = {}
    for orient in ("m", "n"):
        rows = probes.run_sweep(data, *table, orient)
        rows0 = probes.run_sweep(chunk, *group["k3"], orient)
        for r, r0 in zip(rows, rows0):
            log("probes", probe=r["probe"], variant=r["variant"], orientation=orient,
                chunks_per_pass=r["chunks_per_pass"], warps=r["warps"],
                positions_per_block=r["positions_per_block"], production=r["production"],
                equal=True, bench_ms=f"{r['ms']:.4f}", group0_ms=f"{r0['ms']:.4f}")
        sweeps[orient] = min(rows, key=lambda r: r["ms"])

    k4, k3 = times["prefilter_any"], times["prefilter_any8"]
    out = {}
    for row in p6:
        out[row["name"]] = {"source": PROBE_SOURCE, "replaces": P6_REPLACES,
                            "launches": launches[row["name"]], "max_abs_err": 0.0,
                            **{key: row[key] for key in ("ms", "plain_ms", "bound_ms",
                                                         "bound_by", "library_ms")}}
    out["prefilter_lookup"] = {"source": K3_SOURCE, "replaces": P7_REPLACES,
                               "launches": launches["prefilter_lookup"], "max_abs_err": 0.0,
                               **k3, "ms": p7["lookup_ms"]}
    for orient, rep in (("m", P8_REPLACES), ("n", P10_REPLACES)):
        out[f"prefilter_variant_{orient}"] = {
            "source": K3_SOURCE, "replaces": rep,
            "launches": launches[f"prefilter_variant_{orient}"], "max_abs_err": 0.0,
            **k4, "ms": sweeps[orient]["ms"]}
    log("probes", launches=launches,
        best_m=f"variant {sweeps['m']['variant']} {sweeps['m']['ms']:.4f} ms",
        best_n=f"variant {sweeps['n']['variant']} {sweeps['n']['ms']:.4f} ms")
    return out


def checked_launches(checks) -> int:
    """Run each ``(what, fn, want)`` once with the probe counts at 0, fail
    unless ``fn()`` equals ``want``; returns the launches the checks made."""
    from lightmotif_tpu_torch.probes import prefilter as pprobes
    from lightmotif_tpu_torch.probes import scoring

    scoring.reset_launches()
    pprobes.reset_launches()
    for what, fn, want in checks:
        got = fn()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise SystemExit(f"{what}: probe kernel != plain")
    return sum(scoring.LAUNCHES.values()) + sum(pprobes.LAUNCHES.values())


def fmt(row: dict) -> dict:
    return {k: (f"{v:.4f}" if isinstance(v, float) else v) for k, v in row.items()}


def phase_score_probes(pssm, seq, ms, times) -> dict:
    """The scoring probes (``lightmotif_tpu_torch.probes.scoring``) and P9,
    each checked against its plain version with its launches counted from
    0, then timed on the card: family A, every instantiation of the
    scoring kernel in each mode it takes, at the genome (its plain,
    bound and library times are K1's or K2's, measured earlier in this
    run on the same inputs); family B, the diagnostic bodies; family C,
    the op chains over 4,718,592 bytes; P13's host parity; P9, the
    per-lane pass bits beside K3 at database group 0.  Returns the
    ``kernels`` entries of the probes."""
    from lightmotif_tpu_torch.ops import torch_ops
    from lightmotif_tpu_torch.ops.pipeline import DeviceSequence
    from lightmotif_tpu_torch.probes import prefilter as pprobes
    from lightmotif_tpu_torch.probes import scoring

    dseq = DeviceSequence(seq, DEVICE)
    data = dseq.data
    n = len(seq) - len(pssm) + 1
    m = len(pssm)
    w = torch.from_numpy(pssm.data).to(DEVICE)
    d = torch.from_numpy(pssm.to_discrete().data).to(DEVICE)
    tables = {"f32": w, "u8": d}
    plains = {"f32": torch_ops.score_f32(data, w, n), "u8": torch_ops.score_u8(data, d, n)}
    diag_want = {mode: scoring.diag_plain(mode, data, d if mode == "u8out" else w, n)
                 for mode in scoring.DIAG_MODES}
    x = scoring.chain_input(DEVICE)
    chain_tables = [scoring.chain_table(op, DEVICE) for op, _, _ in scoring.CHAINS]

    def variant_checks(vs):
        out = []
        for v in vs:
            for mode, table in tables.items():
                if scoring.accepts(v, mode == "u8", m, table.shape[1]):
                    out.append((f"score variant {v} {mode}",
                                lambda v=v, t=table: scoring.score_variant(v, data, t, n),
                                plains[mode]))
        return out

    def diag_checks(modes):
        return [(f"diag {mode}", lambda mode=mode: scoring.score_diag(
            mode, data, d if mode == "u8out" else w, n), diag_want[mode]) for mode in modes]

    def chain_checks(vs):
        return [(f"chain {v} {scoring.CHAINS[v]}",
                 lambda v=v: scoring.op_chain(v, x, chain_tables[v]),
                 scoring.chain_plain(v, x, chain_tables[v])) for v in vs]

    diag_of = {"P2": ["floor"], "P4": ["io"], "P5": ["u8out"], "P15": ["nosel", "noroll"],
               "P23": ["add"]}
    launches = {}
    for pid, (_, vs) in scoring.PROBE_VARIANTS.items():
        launches[pid] = checked_launches(variant_checks(vs) + diag_checks(diag_of.get(pid, [])))
    launches["P5"] = checked_launches(diag_checks(diag_of["P5"]))
    for pid, (_, vs) in scoring.CHAIN_PROBES.items():
        launches[pid] = checked_launches(chain_checks(vs))

    rows_a = scoring.run_variants(data, w, d, n)
    for row in rows_a:
        log("probes", **fmt(row))
    rows_b = {r["mode"]: r for r in scoring.run_diag(data, w, d, n)}
    for row in rows_b.values():
        log("probes", **fmt(row))
    rows_c = scoring.run_chains(x)
    for row in rows_c:
        log("probes", **fmt(row))
    parity = scoring.pair_parity(pssm.data, seq.data)
    if any(parity["prefix"].values()) or not parity["pairwise"]:
        raise SystemExit(f"P13 pair_parity: {parity}")
    log("probes", probe="P13", host="pair_parity", **parity)

    out = {}
    keys = ("plain_ms", "bound_ms", "bound_by", "library_ms")
    for pid, (rep, vs) in scoring.PROBE_VARIANTS.items():
        rows = [r for r in rows_a if r["variant"] in vs]
        mode = "f32" if any(r["mode"] == "f32" for r in rows) else "u8"
        best = min((r for r in rows if r["mode"] == mode), key=lambda r: r["ms"])
        ref = times["score_f32" if mode == "f32" else "score_u8"]
        out[f"score_variant_{pid.lower()}"] = {
            "source": SOURCE, "replaces": rep, "launches": launches[pid], "max_abs_err": 0.0,
            "ms": best["ms"], **{key: ref[key] for key in keys}}
    lp = data.shape[0]
    io_lib, io_equal = library_ms(lambda: torch.add(data, w[0, 0]),
                                  lambda o: bool(torch.equal(o, diag_want["io"])))
    for pid, mode, nbytes, lib in (("P4", "io", 5 * lp + w.nbytes, io_lib),
                                   ("P5", "u8out", 2 * lp + d.nbytes, None)):
        bound_ms, bound_by = bound(nbytes, 0, "f32")
        out[f"score_diag_{pid.lower()}"] = {
            "source": PROBE_SOURCE, "replaces": scoring.DIAG_PROBES[mode][1],
            "launches": launches[pid], "max_abs_err": 0.0, "ms": rows_b[mode]["ms"],
            "plain_ms": rows_b[mode]["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib}
    log("probes", probe="P4", library="torch.add(seq, w[0, 0])", library_ms=f"{io_lib:.4f}",
        library_equal=io_equal)
    for pid, (rep, vs) in scoring.CHAIN_PROBES.items():
        row = next(r for r in rows_c if r["variant"] == vs[0])
        op, steps, chains = scoring.CHAINS[vs[0]]
        flops = steps * chains * x.shape[0] if op in scoring._FLOAT_OPS else 0
        bound_ms, bound_by = bound(5 * x.shape[0], flops, "f32")
        out[f"op_chain_{pid.lower()}"] = {
            "source": PROBE_SOURCE, "replaces": rep, "launches": launches[pid],
            "max_abs_err": 0.0, "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}

    # P9 at database group 0, K3's inputs and the lanes' valid windows
    group = ms._groups[0]
    n_valid = np.maximum(ms._dseq.length - ms.lengths + 1, 0)
    chunk = ms._dseq.data[: int(n_valid[group["ids"]].max()) + group["m_max"] - 1]
    lanes = np.zeros(group["phase_c"][2].shape[0], np.int32)
    lanes[: len(group["ids"])] = n_valid[group["ids"]]
    nv = torch.from_numpy(lanes).to(DEVICE)
    args = group["k3"]
    launches["P9"] = checked_launches([("P9", lambda: pprobes.prefilter_bits(chunk, *args, nv),
                                        pprobes.prefilter_bits_plain(chunk, *args, nv))])
    p9 = pprobes.run_p9(chunk, *args, nv)
    log("probes", **fmt(p9))
    # K3's bound on the same inputs, or the bits' bytes (one int32 word per
    # position and 16 lanes) if they take longer
    k3_bound = prefilter_bound(chunk, *args)
    bits_bytes = chunk.shape[0] * (1 + 4 * group["phase_c"][2].shape[0] // 16)
    bound_ms, bound_by = max(k3_bound, (bits_bytes / HBM_BYTES_PER_S * 1e3, "bytes"))
    out["prefilter_bits"] = {"source": K3_SOURCE, "replaces": P9_REPLACES,
                             "launches": launches["P9"], "max_abs_err": 0.0,
                             "ms": p9["bits_ms"], "plain_ms": p9["plain_ms"],
                             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    log("probes", launches=launches)
    return out


def scale_genomes() -> list:
    """``(name, EncodedSequence)`` of the scale phase's two genomes: the
    50 Mbp genome of ``bench_biggenome`` and the chromosome stand-in."""
    from lightmotif_tpu_torch import EncodedSequence

    genome = np.random.default_rng(SCALE_GENOME_SEED).integers(
        0, 4, size=SCALE_GENOME_LENGTH, dtype=np.int8).astype(np.uint8)
    return [("genome_50mbp", EncodedSequence(genome)), ("chromosome", chromosome())]


def chromosome():
    """The chromosome stand-in (:func:`scale_genomes`), an
    ``EncodedSequence``."""
    from lightmotif_tpu_torch import DNA, EncodedSequence

    chrom = np.random.default_rng(CHROM_SEED).integers(
        0, 4, size=CHROM_LENGTH, dtype=np.int8).astype(np.uint8)
    start, length = CHROM_GAP
    for lo, hi in ((0, CHROM_END_N), (start, start + length),
                   (CHROM_LENGTH - CHROM_END_N, CHROM_LENGTH)):
        chrom[lo:hi] = DNA.default_index
    return EncodedSequence(chrom)


def memory_mib() -> dict:
    """The current card's allocated peak since the last reset and its
    reserved memory, in MiB."""
    return {"max_allocated_mib": round(torch.cuda.max_memory_allocated() / (1 << 20), 2),
            "reserved_mib": round(torch.cuda.memory_reserved() / (1 << 20), 2)}


def wall_stats(walls) -> dict:
    return {"median_ms": f"{statistics.median(walls):.4f}",
            "p90_ms": f"{float(np.percentile(walls, 90)):.4f}",
            "runs": ",".join(f"{w:.2f}" for w in walls)}


def steady_profile(fn) -> dict:
    """One profiled steady run of ``fn`` (:func:`profiled`): its wall, the
    card's busy ms, its idle share, the host's ms and the top kernels."""
    wall, prof = profiled(fn)
    busy, kernels, n_events, _ = trace_kernels(prof)
    return {"wall_ms": round(wall, 4), "device_busy_ms": round(busy, 4),
            "idle_share": round(1 - busy / wall, 4), "host_ms": round(wall - busy, 4),
            "device_events": n_events,
            "top_kernels_ms": json.dumps({k: round(v, 4) for k, v in kernels[:6]})}


def segments_of(ms, length: int) -> int:
    """The segments of a scan of ``length`` positions by ``ms``: those of
    its shortest motif."""
    return -(-max(length - int(ms.lengths.min()) + 1, 0) // int(ms.SEGMENT))


def group_steps_of(ms) -> int:
    """The (group, segment) steps of a scan of the scanner's bound
    sequence."""
    return sum(isinstance(key, int) for _, key, _ in ms._steps(ms._dseq, ms._owned))


def scale_database(name, seq, pssms, ths) -> tuple:
    """The database through ``MultiScanner.scan_arrays`` on one scale
    genome: the first scan (wall, re-runs, memory) with K3, phase C and the
    pairs kernel once per (group, segment) and per re-run; its hits equal
    to the per-PSSM brute force; a steady scan (a graph replay) launching
    each once per (group, segment); one read per steady ``collect_arrays``
    and none in its dispatch (sync debug mode "error",
    :func:`dispatch_no_reads`); the steady walls and one profiled steady
    run.  Returns the scanner, the brute force's hits and the first scan's
    launches."""
    from lightmotif_tpu_torch.ops import multi
    from lightmotif_tpu_torch.scanner import MultiScanner

    ms = MultiScanner(pssms, thresholds=ths, device=DEVICE)
    settle()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    got = ms.scan_arrays(seq)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches, reruns = launch_counts(), dict(multi.RERUNS)
    steps = group_steps_of(ms)
    want_launches = group_launches(steps)
    if {k: launches[k] for k in want_launches} != want_launches or launches["score_f32"]:
        raise SystemExit(f"scale {name}: first scan launches {launches}, re-runs {reruns}, "
                         f"{steps} (group, segment) steps")
    log("scale", genome=name, check="MultiScanner.scan_arrays, first scan", positions=len(seq),
        segment=ms.SEGMENT, steps=steps, groups=len(ms._groups), hits=len(got[0]),
        first_scan_s=f"{first_s:.3f}", reruns=reruns, launches=launches,
        capacities=ms._group_state, first_scan_reads=ms.host_reads, **memory_mib())

    t0 = time.perf_counter()
    want = brute_force(pssms, ths, ms._dseq)
    brute_s = time.perf_counter() - t0
    check_scan(f"scale {name}", got, want)
    log("scale", genome=name, check="scan_arrays == per-PSSM K1 brute force", hits=len(want[0]),
        brute_force_s=f"{brute_s:.3f}")

    reset_launches()
    check_scan(f"scale {name}, the capture", ms.collect_arrays(), want)
    steady = {k: launch_counts()[k] for k in want_launches}
    if steady != group_launches(steps) or multi.RERUNS["group"]:
        raise SystemExit(f"scale {name}: a replay's launches {steady}, re-runs {multi.RERUNS}")
    log("scale", genome=name, check="a replay launches each kernel once per (group, segment)",
        launches=steady)
    dispatch_no_reads(ms, seq, want, "scale")
    walls = wall_ms(ms.collect_arrays, SCALE_RUNS)
    log("scale", genome=name, op="MultiScanner.collect_arrays, steady", **wall_stats(walls),
        positions_per_s=f"{len(seq) / statistics.median(walls) * 1e3:.4g}",
        pssm_positions_per_s=f"{len(pssms) * len(seq) / statistics.median(walls) * 1e3:.4g}")
    log("scale", genome=name, profile="one steady collect_arrays", **steady_profile(
        ms.collect_arrays), **memory_mib())
    return ms, want, launches


def scale_sweep(name, seq, pssms, ths, want, ecoli) -> None:
    """``MultiScanner`` at each of :data:`SCALE_SEGMENTS` window starts per
    segment on one scale genome: its first scan's wall and re-runs, the
    hits equal to ``want``, one eager scan's peak and what the graphs keep
    (:func:`graph_row`), the steady walls, one profiled steady run's idle
    share; and beside it the steady walls on the bacterial genome
    ``ecoli`` at the same segment."""
    from lightmotif_tpu_torch.ops import multi
    from lightmotif_tpu_torch.scanner import MultiScanner

    for segment in SCALE_SEGMENTS:
        ms = MultiScanner(pssms, thresholds=ths, device=DEVICE)
        ms.SEGMENT = segment
        settle()
        multi.reset_reruns()
        t0 = time.perf_counter()
        check_scan(f"sweep {segment}", ms.scan_arrays(seq), want)
        first_s = time.perf_counter() - t0
        reruns = dict(multi.RERUNS)
        row = graph_row(ms, seq, want, f"sweep {segment}")
        walls = wall_ms(ms.collect_arrays, SCALE_RUNS)
        prof = steady_profile(ms.collect_arrays)
        bacterial = MultiScanner(pssms, thresholds=ths, device=DEVICE)
        bacterial.SEGMENT = segment
        bacterial.scan_arrays(ecoli)
        e_walls = wall_ms(bacterial.collect_arrays)
        log("sweep", genome=name, segment=segment, segments=segments_of(ms, len(seq)),
            first_scan_s=f"{first_s:.3f}", reruns=reruns, **wall_stats(walls),
            idle_share=prof["idle_share"], host_ms=prof["host_ms"],
            device_busy_ms=prof["device_busy_ms"], eager_peak_mib=row["eager_peak_mib"],
            graphs_keep_mib=row["graphs_keep_mib"], rounding_mib=row["rounding_mib"],
            ecoli_segments=segments_of(bacterial, len(ecoli)),
            ecoli_median_ms=f"{statistics.median(e_walls):.4f}",
            ecoli_p90_ms=f"{float(np.percentile(e_walls, 90)):.4f}")
        del ms, bacterial
        settle()


def scale_dense(pssm, dseq, w, n: int, top, last: int) -> None:
    """The Scanner on a scale genome at dense thresholds (0.0, the
    default, and p = 0.5): the hit arrays of a first and a steady
    ``_hits`` equal to K1 + threshold + ``nonzero`` on the card, ``max()``
    equal to K1's last maximum ``(top, last)``, one read per batch of
    ``READ_AHEAD`` in a steady call, and the memory it holds: the card's
    allocated peak above what was allocated before, against the bound of
    four batches' hit buffers (the buffers, their gathered heads or tails,
    the merge of the best hits) and 64 MiB, and the reader's pinned
    buffer."""
    from lightmotif_tpu_torch import Scanner
    from lightmotif_tpu_torch import scanner as scanner_mod
    from lightmotif_tpu_torch.ops import kernels

    for label, t in (("0.0, the default", 0.0),
                     ("p = 0.5", pssm.score_distribution().score(0.5))):
        scores = kernels.score_f32(dseq.data, w, n)[:n]
        hit = torch.nonzero(scores >= torch.tensor(t, device=DEVICE)).flatten()
        want_pos = hit.cpu().numpy()
        want_bits = (scores[hit] + 0.0).cpu().numpy().view(np.uint32)
        del scores, hit
        settle()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        scanner = Scanner(pssm, dseq, threshold=t)
        t_scaled = int(scanner.dm.scale(t))
        row = {}
        for run in ("first", "steady"):
            scanner.host_reads = 0
            t0 = time.perf_counter()
            pos, scores = scanner._hits(t_scaled, t)
            row[f"{run}_ms"] = f"{(time.perf_counter() - t0) * 1e3:.4f}"
            row[f"{run}_reads"] = scanner.host_reads
            if not (np.array_equal(pos, want_pos)
                    and np.array_equal((scores + np.float32(0.0)).view(np.uint32), want_bits)):
                raise SystemExit(f"scale dense {label}: {len(pos)} hits vs {len(want_pos)}")
        del pos, scores
        scanner.host_reads = 0
        best = scanner.max()
        if best is None or (best.position, f32_bits(best.score)) != (last, f32_bits(top)):
            raise SystemExit(f"scale dense {label}: max {best} against ({top}, {last})")
        peak = torch.cuda.max_memory_allocated() - base
        buffer = scanner._reader._buffer
        pinned = 0 if buffer is None else buffer.numel()
        segments = -(-n // scanner.block_size)
        per = max(1, scanner_mod.READ_AHEAD // (8 * scanner.capacity))
        batch = min(per, segments) * 8 * scanner.capacity
        bound = 4 * batch + (64 << 20)
        mib = 1 << 20
        log("scale", check="Scanner at a dense threshold == K1 + threshold + nonzero; max == "
            "K1's last maximum; one read a batch; memory inside four batches and 64 MiB",
            threshold=label, t=f"{t:.6f}", hits=len(want_pos),
            segments=segments, capacity=scanner.capacity, reruns=scanner.reruns,
            segments_a_read=min(per, segments), **row, max_reads=scanner.host_reads,
            peak_mib=round(peak / mib, 2), bound_mib=round(bound / mib, 2),
            batch_mib=round(batch / mib, 2), pinned_mib=round(pinned / mib, 2),
            read_ahead_mib=round(scanner_mod.READ_AHEAD / mib, 2))
        batches = -(-segments // per)
        if row["steady_reads"] != batches or scanner.host_reads != batches:
            raise SystemExit(f"scale dense {label}: {row['steady_reads']} reads a steady "
                             f"call and {scanner.host_reads} a max, {batches} batches")
        if peak > bound or pinned > 2 * batch + (1 << 20):
            raise SystemExit(f"scale dense {label}: {peak / mib:.2f} MiB allocated at the "
                             f"peak (bound {bound / mib:.2f}), {pinned / mib:.2f} MiB pinned")
        del scanner
        settle()


def scale_single(pssm, seq, sweep: bool) -> dict:
    """MX000001 on a scale genome: ``Pipeline.score_max`` (K1 once)
    against K1 plus a host scan of the last maximum, ``Scanner.collect()``
    at p = 1e-5 (K2 once per segment of ``DEFAULT_SEGMENT``) against K1 +
    threshold + ``nonzero`` on the card, their walls, and
    :func:`scale_dense`; with ``sweep``, the Scanner at each of
    :data:`SCALE_SEGMENTS` and two larger segments.  Returns the launches
    of the two drives."""
    from lightmotif_tpu_torch import Scanner
    from lightmotif_tpu_torch.ops import kernels
    from lightmotif_tpu_torch.ops.pipeline import DeviceSequence, Pipeline

    dseq = DeviceSequence(seq, DEVICE)
    n = dseq.length - len(pssm) + 1
    t = pssm.score_distribution().score(1e-5)
    w = torch.from_numpy(np.ascontiguousarray(pssm.data, np.float32)).to(DEVICE)
    scores = kernels.score_f32(dseq.data, w, n)[:n]
    host = scores.cpu().numpy()
    top = host.max()
    tops = np.flatnonzero(host == top)
    last = int(tops[-1])
    hit = torch.nonzero(scores >= torch.tensor(t, device=DEVICE)).flatten()
    want_pos, want_bits = hit.cpu().numpy(), (scores[hit] + 0.0).cpu().numpy().view(np.uint32)
    del scores, host

    reset_launches()
    mx, am = Pipeline(DEVICE).score_max(pssm, seq)
    total = dict(launch_counts())
    if am != last or f32_bits(mx) != f32_bits(top) or total["score_f32"] != 1:
        raise SystemExit(f"scale score_max: ({mx}, {am}) against ({top}, {last}), "
                         f"launches {total}")
    walls = wall_ms(lambda: Pipeline(DEVICE).score_max(pssm, dseq), SCALE_RUNS)
    log("scale", check="Pipeline.score_max == K1 + a host scan of the last maximum",
        positions=len(seq), argmax=am, bits=hex(f32_bits(mx)),
        positions_at_the_maximum=len(tops),
        resident=wall_stats(walls)["median_ms"], launches=total)

    def collect(scanner, what):
        reset_launches()
        hits = scanner.collect()
        launches = launch_counts()
        pos = np.array([h.position for h in hits], dtype=np.int64)
        bits = (np.array([h.score for h in hits], dtype=np.float32) + np.float32(0.0)).view(
            np.uint32)
        if not (np.array_equal(pos, want_pos) and np.array_equal(bits, want_bits)):
            raise SystemExit(f"scale {what}: {len(hits)} hits vs {len(want_pos)}")
        return launches

    settle()
    torch.cuda.reset_peak_memory_stats()
    scanner = Scanner(pssm, seq, threshold=t)
    segments = -(-n // scanner.block_size)
    launches = collect(scanner, "Scanner.collect")
    runs = segments + scanner.reruns
    if launches["scan_segment"] != runs or launches["score_u8"]:
        raise SystemExit(f"scale Scanner.collect: launches {launches}, {segments} segments, "
                         f"{scanner.reruns} re-runs")
    for name, v in launches.items():
        total[name] = total.get(name, 0) + v
    first = {"first_reads": scanner.host_reads, "reruns": scanner.reruns,
             "capacity": scanner.capacity}
    scanner = Scanner(pssm, dseq, threshold=t)
    walls = wall_ms(scanner.collect, SCALE_RUNS)
    scanner.host_reads = 0
    collect(scanner, "a steady Scanner.collect")
    if scanner.host_reads != 1:
        raise SystemExit(f"scale: a steady Scanner.collect read {scanner.host_reads} times")
    log("scale", check="Scanner.collect == K1 + threshold + nonzero on the card; a steady "
        "collect reads once", threshold=t, hits=len(want_pos), segments=segments,
        segment=scanner.block_size, launches=launches, **first, steady_reads=1,
        **wall_stats(walls), **memory_mib())
    log("scale", profile="one steady Scanner.collect on the chromosome",
        **steady_profile(scanner.collect))
    t_scaled = int(scanner.dm.scale(t))
    log("scale", op="Scanner._hits on the chromosome (the hit arrays, no Hit objects)",
        **wall_stats(wall_ms(lambda: scanner._hits(t_scaled, t), SCALE_RUNS)))
    del scanner
    scale_dense(pssm, dseq, w, n, top, last)
    if sweep:
        for block in (*SCALE_SEGMENTS, 1 << 26, 1 << 28):
            settle()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            scanner = Scanner(pssm, dseq, threshold=t, block_size=block)
            collect(scanner, f"Scanner.collect, block_size {block}")
            peak = torch.cuda.max_memory_allocated() - base
            log("sweep", op="Scanner.collect", positions=len(seq), block_size=block,
                segments=-(-n // block), peak_mib=round(peak / (1 << 20), 2),
                **wall_stats(wall_ms(scanner.collect, SCALE_RUNS)))
    return total


def scale_sharded(name, seq, ms, want) -> dict:
    """``ShardedMultiScanner`` on a scale genome: on MESH_SHARDS shards of
    the first card and, with two or more cards, on 1..N cards, one shard
    each: its hits equal to ``want`` (the single-card hits), K3, phase C and
    the pairs kernel once per (group, shard, segment), one read per steady
    ``collect_arrays`` and none in its issue (sync debug mode "error"),
    its walls in turns with ``ms`` (the single-card ``MultiScanner``, bound
    to ``seq``), and one profiled run's split per card.  Returns the first
    scans' launches."""
    from lightmotif_tpu_torch.parallel import ShardedMultiScanner, make_genome_mesh

    cards = make_genome_mesh()
    meshes = [(f"{MESH_SHARDS} shards of one card", [cards[0]] * MESH_SHARDS)]
    if len(cards) > 1:
        meshes += [(f"{k} cards", cards[:k]) for k in range(1, len(cards) + 1)]
    else:
        log("scale", genome=name, multi_card=f"not run, {len(cards)} device")
    total, walls = {}, {}
    for label, mesh in meshes:
        reset_launches()
        t0 = time.perf_counter()
        sm = ShardedMultiScanner(ms.pssms, thresholds=ms.thresholds, mesh=mesh)
        got = sm.scan_arrays(seq)
        sync_all()
        first_s = time.perf_counter() - t0
        launches = launch_counts()
        want_launches = group_launches(mesh_k3_launches(sm))
        if {k: launches[k] for k in want_launches} != want_launches:
            raise SystemExit(f"scale {name}, {label}: launches {launches}, "
                             f"expected {want_launches}")
        check_scan(f"scale {name}, ShardedMultiScanner on {label}", got, want)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        mesh_issue_no_reads(sm, want, "scale")
        sharded_ms, single_ms, runs = walls_in_turns(
            sm.collect_arrays, lambda: ms.scan_arrays(seq), SCALE_RUNS)
        walls[label] = (len(set(mesh)), float(sharded_ms))
        wall, prof = profiled(sm.collect_arrays)
        run_ms, per_card, _ = card_split(prof, list(dict.fromkeys(mesh)))
        log("scale", genome=name, check="ShardedMultiScanner == one card; one read a call",
            mesh=label, shards=len(sm._bound.shards), first_scan_s=f"{first_s:.3f}",
            launches=launches, sharded_ms=sharded_ms, single_ms=single_ms, runs=runs,
            profiled_wall_ms=f"{wall:.4f}", per_card=json.dumps(
                [{k: v for k, v in c.items() if k != "idle_host"} for c in per_card]))
        del sm
        settle()
    if len(cards) > 1:
        one = walls["1 cards"][1]
        log("scale", genome=name, scaling="ShardedMultiScanner.collect_arrays, one card's "
            "wall / (cards x the wall)", **{f"cards_{k}": f"{one / (k * w):.3f}"
                                            for label, (k, w) in walls.items()
                                            if label.endswith("cards")})
    return total


def scale_cli(seq, counts, ms, want) -> dict:
    """The CLI on the scale genome as one FASTA record against the
    database written as JASPAR16, both strands at p = 1e-6 (``cli.main``
    in this process): its TSV rows equal to ``want`` (the scanner's hits;
    the p-values are ``dist.pvalue``'s), K3, phase C and the pairs kernel
    once per (group, segment) and per re-run; and its split: the record
    read and encoded as the CLI's reader does it and by the native
    one-pass reader (each with its rate), the motifs' preparation, the
    first scan of the CLI's scanner (packing included), and the rest of
    the CLI's record (a ``MultiHit``, a p-value and a row per hit), from
    its own ``cli_timing``.  Returns the CLI run's launches."""
    import os
    import shutil
    import tempfile

    from lightmotif_tpu_torch import EncodedSequence, cli, fasta
    from lightmotif_tpu_torch.scanner import MultiScanner

    work = tempfile.mkdtemp(prefix="chip-smoke-scale-cli-")
    try:
        db_file = os.path.join(work, "database.jaspar16")
        write_jaspar16(db_file, counts, "SY")
        genome_fa = os.path.join(work, "genome.fa")
        write_fasta(genome_fa, [("genome", seq)])
        fa_bytes = os.path.getsize(genome_fa)
        split = {}

        def timed(key, fn):
            t0 = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
            split[key] = time.perf_counter() - t0
            return out

        records = timed("read_encode_s", lambda: [
            EncodedSequence.encode_lossy(r.sequence) for r in fasta.read_fasta(genome_fa)])
        native = timed("native_read_encoded_s", lambda: fasta.read_fasta_encoded(genome_fa))
        if not (np.array_equal(records[0].data, seq.data)
                and np.array_equal(native[0][2].data, seq.data)):
            raise SystemExit("scale cli: the FASTA record does not encode to the genome")
        args = cli.build_parser().parse_args(
            ["-m", db_file, "--format", "jaspar16", "-s", genome_fa, "-o", "-",
             "-P", str(DB_PVALUE), "--reverse"])
        jobs = timed("prepare_motifs_s", lambda: cli.prepare_motifs(args))
        strands = cli._build_strands(jobs, args)
        timed("first_scan_s", lambda: MultiScanner(
            [p for _, _, p in strands], thresholds=[j.threshold for j, _, _ in strands],
            single_bucket=True, device=DEVICE).scan_arrays(records[0]))
        del records, native

        out = os.path.join(work, "genome.tsv")
        launches, wall, timing = run_cli(
            ["-m", db_file, "--format", "jaspar16", "-s", genome_fa, "-o", out,
             "-P", str(DB_PVALUE), "--reverse"], "scale database x genome")
        t0 = time.perf_counter()
        si, mo, rev, pos, bits = cli_rows(out)
        parse_s = time.perf_counter() - t0
        ids = mo + DB_MOTIFS * rev
        order = np.lexsort((pos, ids))
        if not (np.array_equal(ids[order], want[0]) and np.array_equal(pos[order], want[1])
                and np.array_equal(bits[order], want[2]) and not si.any()):
            raise SystemExit(f"scale cli: rows != scan_arrays ({len(pos)} rows vs "
                             f"{len(want[0])})")
        expect = group_launches(cli_group_steps(ms, len(seq)))
        if {name: launches[name] for name in expect} != expect:
            raise SystemExit(f"scale cli: launches {launches}, expected {expect}")
        rest = timing["startup_s"] - split["read_encode_s"] - split["first_scan_s"]
        log("scale", check="the CLI's TSV rows == scan_arrays", rows=len(pos),
            fasta_bytes=fa_bytes, wall_s=f"{wall:.3f}", launches=launches,
            cli_timing=json.dumps(timing), tsv_parse_s=f"{parse_s:.3f}")
        log("scale", split="the CLI on one record", **{k: f"{v:.3f}" for k, v in split.items()},
            read_encode_mb_s=f"{fa_bytes / split['read_encode_s'] / 1e6:.1f}",
            native_mb_s=f"{fa_bytes / split['native_read_encoded_s'] / 1e6:.1f}",
            rest_s=f"{rest:.3f}", rest_us_per_hit=f"{rest / max(len(pos), 1) * 1e6:.2f}")
        return launches
    finally:
        shutil.rmtree(work, ignore_errors=True)


def cli_group_steps(ms, length: int) -> int:
    """The (group, segment) steps of the CLI's database scan of a record of
    ``length`` symbols: the groups of ``ms``'s motifs as the CLI's scanner
    routes them, each over the segments of its shortest motif."""
    from lightmotif_tpu_torch.ops import multi
    from lightmotif_tpu_torch.scanner import MultiScanner

    k = ms.pssms[0].alphabet.size
    short, _ = multi.route_motifs(ms.pssm_stack, ms.lengths, ms.thresholds, k,
                                  MultiScanner.dense_m_limit(k))
    size = MultiScanner.GROUP_MOTIFS
    return sum(-(-max(length - int(ms.lengths[short[s:s + size]].min()) + 1, 0)
                 // MultiScanner.SEGMENT) for s in range(0, short.size, size))


def phase_scale(pssm, pssms, ths, counts, ecoli, sweep: bool = False) -> dict:
    """The database scan at chromosome scale, and the paths beside it:
    on the 50 Mbp genome and on the chromosome, ``MultiScanner``
    (:func:`scale_database`), what its graphs keep on 2 segments and on
    all of them (:func:`graph_memory`), ``ShardedMultiScanner``
    (:func:`scale_sharded`); MX000001 on the chromosome
    (:func:`scale_single`); the CLI on the 50 Mbp genome
    (:func:`scale_cli`).  With ``sweep``, ``MultiScanner`` on the 50 Mbp
    genome and the Scanner on the chromosome at each segment size.  Returns
    the launches of every drive."""
    from lightmotif_tpu_torch.scanner import MultiScanner

    total = {}

    def add(launches):
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v

    t0 = time.perf_counter()
    genomes = scale_genomes()
    log("scale", genomes=",".join(f"{n}={len(s)}" for n, s in genomes),
        chromosome_n=int((np.asarray(genomes[1][1].data) == 4).sum()),
        inputs_s=f"{time.perf_counter() - t0:.3f}")
    segments = {}
    for name, seq in genomes:
        ms, want, launches = scale_database(name, seq, pssms, ths)
        add(launches)
        segments[name] = segments_of(ms, len(seq))
        if sweep and name == "genome_50mbp":
            scale_sweep(name, seq, pssms, ths, want, ecoli)
        add(scale_sharded(name, seq, ms, want))
        if name == "chromosome":
            add(scale_single(pssm, seq, sweep))
        else:
            add(scale_cli(seq, counts, ms, want))
        del ms, want
        settle()
    for name, seq in genomes[::-1]:
        graph_memory(pssms, ths, seq, MultiScanner.SEGMENT, (2, segments[name]), phase="scale")
    log("scale", launches=total, seconds=f"{time.perf_counter() - t0:.3f}")
    return total


def scale_only() -> int:
    """The build, then :func:`phase_scale` with its sweeps."""
    phase_card()
    phase_build()
    pssm, ecoli = build_inputs()
    pssms, ths, counts = synthetic_database(DB_MOTIFS, DB_SEED)
    phase_scale(pssm, pssms, ths, counts, ecoli, sweep=True)
    print(json.dumps({"ok": True, "scale_only": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main(argv: list) -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    parent = argv[-1] if len(argv) >= 2 and argv[-2] == "--parent" else None
    mode = argv[:-2] if parent is not None else argv
    if mode == ["--mesh-only"]:
        return mesh_only(parent)
    if mode == ["--scale-only"] and parent is None:
        return scale_only()
    if mode == ["--stages-only"] and parent is not None:
        return stages_only(parent)
    if mode == ["--one-pssm-cards"]:
        return one_pssm_cards(parent)
    if mode == ["--segment-times"]:
        return segment_times(parent)
    if mode:
        print(f"chip_smoke: unknown arguments {argv} (--mesh-only [--parent DIR], "
              "--scale-only, --parent DIR, --stages-only --parent DIR, "
              "--one-pssm-cards [--parent DIR], --segment-times [--parent DIR], or none)",
              file=sys.stderr)
        return 2
    phase_card()
    phase_imports()
    phase_build()
    phase_sass()
    pssm, seq = build_inputs()
    errs = phase_kernels(pssm, seq)
    errs["scan_segment"] = phase_scan_segment(pssm, seq)
    cases = list(prefilter_cases())
    errs["prefilter_any8"] = phase_k3(cases)
    errs.update(phase_k4k5(cases, seq))
    del cases
    launches, scanner_hits = phase_main_path(pssm, seq)
    ms, db_launches, brute, counts = phase_database(seq)
    launches.update({name: db_launches[name] for name in group_launches(0)})
    db, groups5, launches5, launches4 = phase_modes(ms, seq, brute)
    launches["prefilter_any16"] = launches5["prefilter_any16"]
    launches["prefilter_any"] = launches4["prefilter_any"]
    stage_times = phase_stages(ms, "database (K3 mode)", timed=True)
    phase_other_paths(seq)
    records, br, mbs, batch_hits = phase_batch(pssm, seq, ms)
    phase_cli(pssm, seq, ms, counts, records, batch_hits, scanner_hits, brute)
    # the last slice's paths: each kernel's launches there join its count
    phase_tfmpvalue(pssm)
    launches["score_f32"] += phase_sampler()
    phase_batch_sampler()
    for name, n in phase_mesh(pssm, seq, ms, scanner_hits, brute).items():
        launches[name] += n
    phase_mesh_cards(pssm, seq, ms, scanner_hits, brute, counts)
    phase_mesh_procs(scanner_hits, brute)
    times = phase_times(pssm, seq)
    times["prefilter_any8"] = phase_database_times(ms, seq)
    times.update(stage_times)
    times.update(phase_mode_times(ms, seq, db, groups5))
    phase_batch_times(pssm, records, br, mbs)
    phase_host_cost(pssm, seq)
    probe_entries = phase_probes(ms, seq, times)
    probe_entries.update(phase_score_probes(pssm, seq, ms, times))
    for name, n in phase_scale(pssm, ms.pssms, ms.thresholds, counts, seq).items():
        launches[name] += n
    if parent is not None:
        phase_parent(parent)
    sources = {"score_f32": (SOURCE, REPLACES), "score_u8": (SOURCE, REPLACES),
               "prefilter_any8": (K3_SOURCE, K3_REPLACES),
               "prefilter_any": (K3_SOURCE, K4_REPLACES),
               "prefilter_any16": (K3_SOURCE, K5_REPLACES),
               "phase_c_bits": (PHASE_C_SOURCE, PHASE_C_REPLACES),
               "pairs_rescore": (PAIRS_SOURCE, PAIRS_REPLACES),
               "scan_segment": (SEGMENT_SOURCE, SEGMENT_REPLACES)}
    errs.update(STAGE_ERRS)  # the worst of every check of the two
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         **{key: times[name][key] for key in keys}}
        for name, (src, rep) in sources.items()] + [
        {"name": name, "route": "cuda", "source": e["source"], "replaces": e["replaces"],
         "launches": e["launches"], "max_abs_err": e["max_abs_err"],
         **{key: e[key] for key in keys}}
        for name, e in probe_entries.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def stages_only(parent: str) -> int:
    """The build and its SASS, then :func:`phase_parent` against the
    checkout at ``parent``."""
    phase_card()
    phase_build()
    phase_sass()
    phase_parent(parent)
    print(json.dumps({"ok": True, "stages_only": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def mesh_only(parent: str | None = None) -> int:
    """The sharded scans alone, with what they are held to: the build,
    the Scanner's and the database's single-device hits, then the mesh
    phases (for a run on several cards), the sharded database scan of the
    scale phase's two genomes against ``MultiScanner`` on the first card
    (:func:`scale_sharded`), and with ``parent`` the walls against that
    checkout (:func:`phase_parent`)."""
    from lightmotif_tpu_torch.scanner import MultiScanner

    phase_card()
    phase_build()
    pssm, seq = build_inputs()
    _, scanner_hits = phase_main_path(pssm, seq)
    ms, _, brute, counts = phase_database(seq)
    phase_mesh(pssm, seq, ms, scanner_hits, brute)
    phase_mesh_cards(pssm, seq, ms, scanner_hits, brute, counts)
    phase_mesh_procs(scanner_hits, brute)
    for name, genome in scale_genomes():
        single = MultiScanner(ms.pssms, thresholds=ms.thresholds, device=DEVICE)
        mo, pos, sc = single.scan_arrays(genome)
        scale_sharded(name, genome, single, (mo, pos, (sc + np.float32(0.0)).view(np.uint32)))
        del single
        settle()
    if parent is not None:
        phase_parent(parent)
    print(json.dumps({"ok": True, "mesh_only": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
