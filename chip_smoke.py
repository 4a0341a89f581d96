#!/usr/bin/env python
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; every module of the port imported, with no JAX;
2. build: ``nvcc`` compiles ``lightmotif_tpu_torch/ops/csrc/*.cu`` for
   ``sm_90a``, one process per source, all at once: first the production
   build (``score.cu``, ``prefilter.cu``), then the probe build
   (``probes.cu``), each with its own seconds;
3. SASS: ``cuobjdump -sass`` of the prefilter library, the tensor-core
   instructions (``IMMA``) of every instantiation of the tensor-core
   prefilter, the production one and P9's bits form included (each must
   hold some; the lookup kernel of probe P7 holds none); of the scoring
   library, K1's production instantiation adds with ``FADD`` and has no
   ``FFMA`` (no contraction), K2's looks up with ``PRMT``;
4. K1 and K2 against their plain PyTorch versions on the card
   (``torch.equal``): DNA (through the production instantiations, and the
   generic one past K2's m = 257), protein, k = 7 and k = 256 tables,
   random sequences with ranks >= K and wildcard runs, ragged
   ``n_scores``, and the main path's own shapes;
5. the main path at full size: an E. coli-sized genome (4,641,652 bp,
   seed 0xECC011) against PRODORIC MX000001 -- full-genome bit parity
   of ``pssm.score`` with the sequential host oracle, the known best
   hit (position 3,254,602, f32 bits 0x4197E448, which must win the
   exact tie with position 2,558,379), and the two-pass ``Scanner`` at
   p = 1e-5 against the host brute force, in one segment and in five;
   both kernels must have been launched by this phase;
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
   +0.0); K3 must have been launched by the scan;
9. the prefilter modes at full size, through the package's
   ``multi.route_motifs``, ``multi.database_groups`` and
   ``multi.scan_groups``: the same database through the u16 (K5) mode
   in 1 and 5 segments, equal to the K3 mode and the brute force, and
   through the u8 (K4) mode in groups of 512 lanes, equal to the K3
   mode (the genome has no wildcard); each must launch its kernel once
   per group and segment.  In each mode the segment entry
   ``multi.scan_multi_segment_fused``, given the first group's JAX
   filters, must give that group's hits with one launch;
10. the dense path (four DNA motifs of m 129-257) and a protein database
    (200 motifs of m 5-40 over 1,000,000 residues) against the same
    brute force; each scan must have launched K1 once per dense motif
    and K3 once per motif group;
11. batched records: the genome cut into seeded records of 50-2,000 bp
    (some shorter than the motif) through ``BatchReducer`` (against the
    per-record host oracle), ``BatchScanner`` at p = 1e-5 (against
    per-record Scanners) and ``MultiBatchScanner`` with the database
    (against the brute force over the concatenation, windows inside one
    record); each class's launches are counted from 0 over its own call
    and must be K1 once, K2 once per segment and K3 once per motif group
    and segment;
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
    card: ``ShardedScanner`` equal to phase 5's Scanner hits, its
    ``max`` and ``sharded_argmax`` the known best hit, which wins its tie
    across shards 4 and 5; ``ShardedMultiScanner`` with the database, on
    the 8 shards and on the default mesh, equal to ``MultiScanner`` and
    the brute force (K3 once per group and shard); the dense motifs of
    phase 10 through the mesh (K1 once per motif and shard); each wall
    beside the single-device wall of the same call;
17. two processes joined with ``torch.distributed`` (gloo), both on the
    card, four shards each, over the genome and the database: their
    merged hits equal the single-process hits, and both report the known
    argmax and the same per-shard counts.
18. times on the card (CUDA events, median of 15 samples after a
    warm-up), each kernel beside its plain version, its bound (the least
    time the card could take: bytes over HBM's rate or operations over
    the card's peak) and a ``conv1d`` library yardstick: device time per
    launch (launches queued behind a GPU spin), and one call with the
    host's launch cost; then ``score_max``, the Scanner's wall time, K3,
    K4 and K5 at their shapes, the database scan's steady-state wall in
    the K3 and u16 modes and, from one more run through the scanner's
    timing hook and ``torch.profiler``, its split by stage, device-busy
    time and host time; the batch classes' walls;
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
    forms none); P9, the per-lane pass bits beside K3 at database group 0.

The line before the last is a JSON object with one entry per kernel
(launches counted on the path that runs it, with the counts reset just
before it; for a probe, in its own check); the last line is ``{"ok":
true, "device": {...}}``.  There is no CPU path: without a CUDA device
the script fails.
"""

from __future__ import annotations

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
    from lightmotif_tpu_torch.ops import kernels, multi_kernel

    kernels.reset_launches()
    multi_kernel.reset_launches()


def launch_counts() -> dict:
    """The launches of every kernel wrapper since the last reset."""
    from lightmotif_tpu_torch.ops import kernels, multi_kernel

    return {**kernels.LAUNCHES, **multi_kernel.LAUNCHES}


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


def phase_sass() -> int:
    """The prefilter library's SASS: every tensor-core instantiation, the
    production one and P9's bits form included, must hold tensor-core
    instructions; the lookup kernel (P7's baseline) holds none.  The
    scoring library's: K1's production instantiation adds with FADD and
    never with FFMA (no contraction), K2's looks up with PRMT.  Returns
    the production prefilter's IMMA count."""
    from lightmotif_tpu_torch.ops import build
    from lightmotif_tpu_torch.probes import prefilter as probes

    lib = next(p for p in build.build_info()["paths"] if "prefilter" in p.name)
    counts = sass_mma_counts(lib)
    v = build.library().lm_prefilter_production()
    orient, cpp, pw, warps = probes.VARIANTS[v]
    mangled = f"mma_kernelILb{int(orient == 'm')}ELi{cpp}ELi{pw}ELi{warps}ELb0EE"
    production = [n for n in counts if mangled in n]
    per_variant = {n.split("mma_kernel")[1].split("ELb0EEEvPKh")[0]: c
                   for n, c in counts.items() if "mma_kernel" in n and "ELb0EEEvPKh" in n}
    bits = [c for n, c in counts.items() if "mma_kernel" in n and "ELb1EEEvPKh" in n]
    lookup = sum(c for n, c in counts.items() if "lookup_kernel" in n)
    if (len(production) != 1 or counts[production[0]] < 1 or len(bits) != 1 or bits[0] < 1
            or len(per_variant) != len(probes.VARIANTS) or min(per_variant.values()) < 1):
        raise SystemExit(f"sass: a tensor-core instantiation without IMMA: {counts}")
    log("sass", library=lib.name, tool="cuobjdump -sass",
        production=f"variant {v} {probes.VARIANTS[v]}", production_imma=counts[production[0]],
        p9_bits_imma=bits[0], total_tensor_core=sum(counts.values()), lookup_kernel=lookup,
        per_instantiation=per_variant)

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
    return counts[production[0]]


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


def phase_main_path(pssm, seq) -> tuple:
    """The main path on the genome; returns its launches and the
    Scanner's hits at p = 1e-5 (positions, f32 bits)."""
    from lightmotif_tpu_torch import Scanner
    from lightmotif_tpu_torch.ops import kernels
    from lightmotif_tpu_torch.ops.pipeline import Pipeline
    from lightmotif_tpu_torch.scanner import DEFAULT_SEGMENT

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

    for block_size in (DEFAULT_SEGMENT, n // 4):
        scanner = Scanner(pssm, seq, threshold=t, block_size=block_size)
        hits = scanner.collect()
        pos = np.array([h.position for h in hits], dtype=np.int64)
        bits = np.array([f32_bits(h.score) for h in hits], dtype=np.uint32)
        if not (np.array_equal(pos, want_pos) and np.array_equal(bits, want_bits)):
            raise SystemExit(f"Scanner != brute force at block_size {block_size}: "
                             f"{len(hits)} hits vs {len(want_pos)}")
        log("main", check="Scanner.collect", threshold=t, hits=len(hits),
            segments=-(-n // block_size))
    best = Scanner(pssm, seq, threshold=t).max()
    if best.position != KNOWN_BEST_POS or f32_bits(best.score) != KNOWN_BEST_BITS:
        raise SystemExit(f"Scanner.max failed: {best}")
    log("main", check="Scanner.max", position=best.position)

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


def phase_database(seq):
    """The database path at full size; returns (scanner, its launches,
    the brute force's hits, the forward strands' count matrices)."""
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
    if launches["prefilter_any8"] < 1:
        raise SystemExit(f"the database scan never launched K3: {launches}")
    routing = ms._route()
    log("database", live=len(routing["short_idx"]) + len(routing["dense_idx"]),
        pruned=len(pssms) - len(routing["short_idx"]) - len(routing["dense_idx"]),
        groups=len(ms._groups), group_rows=[g["m_max"] for g in ms._groups],
        dense=len(routing["dense_idx"]), hits=len(got[0]),
        first_scan_s=f"{first_s:.3f}", launches=launches)

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
    return ms, launches["prefilter_any8"], want, counts


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
        """Hit arrays through ``groups``, sorted as ``scan_arrays`` sorts."""
        from lightmotif_tpu_torch.ops import multi

        return multi.sorted_hits(multi.scan_groups(
            self.dseq.data, self.dseq.length, self.ms.lengths, groups, self.k, segment))

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
        multi_kernel.reset_launches()
        pos, lanes, scores = multi.scan_multi_segment_fused(
            self.dseq.data, 0, n_valid, filters.pop("filters_t"), g["pssm"], g["th"],
            int(n_valid.max()) + g["m_max"] - 1, 0, g["m_max"], self.k, **filters)
        torch.cuda.synchronize()
        launches = dict(multi_kernel.LAUNCHES)
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
    if launches[name] != 1 or sum(launches.values()) != 1:
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
    brute force in 1 and 5 segments; each mode must launch its kernel
    once per group and segment.  The segment entry, given group 0's JAX
    filters, must give that group's hits in each mode.  Returns (the
    ModeDatabase, K5 groups, K5 launches of the one-segment run, K4
    launches)."""
    from lightmotif_tpu_torch.ops import multi_kernel

    db = ModeDatabase(ms, seq)
    want = ms.scan_arrays(seq)
    n = len(seq) - int(ms.lengths.min()) + 1
    t0 = time.perf_counter()
    groups5 = db.groups("k5")
    pack_s = time.perf_counter() - t0
    launches5 = None
    for segments in (1, 5):
        segment = -(-n // segments)
        multi_kernel.reset_launches()
        t0 = time.perf_counter()
        got = db.scan(groups5, segment)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        runs = dict(multi_kernel.LAUNCHES)
        if runs["prefilter_any16"] != len(groups5) * segments or runs["prefilter_any8"]:
            raise SystemExit(f"u16 mode, {segments} segments, {len(groups5)} groups: "
                             f"launches {runs}")
        launches5 = launches5 or runs["prefilter_any16"]
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
    multi_kernel.reset_launches()
    t0 = time.perf_counter()
    got = db.scan(groups4, n)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches4 = dict(multi_kernel.LAUNCHES)
    if launches4["prefilter_any"] != len(groups4) or launches4["prefilter_any16"]:
        raise SystemExit(f"u8 mode, {len(groups4)} groups: launches {launches4}")
    # the genome has no wildcard, so the u8 test misses no hit
    if not same_hits(got, want):
        raise SystemExit("u8 mode: hits != the K3 mode's")
    log("modes", mode="u8 (K4)", segments=1, groups=len(groups4),
        group_lanes=K4_GROUP_LANES, group_rows=[g["m_max"] for g in groups4],
        hits=len(got[0]), equal_k3_mode=True, launches=launches4,
        scan_s=f"{wall:.3f}", pack_s=f"{pack_s:.3f}")
    check_segment_entry(db, "k4", want, "u8 mode")
    return db, groups5, launches5, launches4["prefilter_any"]


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
    for the reducer, K2 once per segment for the scanner, K3 once per
    motif group and segment for the database.  Returns (records, the
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
    expect("BatchScanner.collect", launches_bs,
           {"score_u8": -(-n_windows // DEFAULT_SEGMENT)})
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
    expect("MultiBatchScanner.collect_arrays", launches_mbs, {"prefilter_any8": want_k3})
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
    from lightmotif_tpu_torch.ops import multi
    from lightmotif_tpu_torch.scanner import MultiScanner

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

        k = ms.pssms[0].alphabet.size
        short, _ = multi.route_motifs(ms.pssm_stack, ms.lengths, ms.thresholds, k,
                                      MultiScanner.dense_m_limit(k))
        size = MultiScanner.GROUP_MOTIFS
        group_min_m = [int(ms.lengths[short[s:s + size]].min())
                       for s in range(0, short.size, size)]

        def k3_launches(length):
            return sum(-(-max(length - m + 1, 0) // MultiScanner.SEGMENT)
                       for m in group_min_m)

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
        want_k3 = k3_launches(len(seq))
        if launches["prefilter_any8"] != want_k3 or launches["score_u8"]:
            raise SystemExit(f"cli database x genome: launches {launches}, "
                             f"expected prefilter_any8={want_k3}")
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
            want_k3 = sum(k3_launches(sum(n + gap for n in f) if len(f) > 1 else f[0])
                          for f in flights)
            if launches["prefilter_any8"] != want_k3:
                raise SystemExit(f"cli database x records ({flight_bytes}): launches "
                                 f"{launches}, expected prefilter_any8={want_k3} over "
                                 f"{len(flights)} flights")
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
        if launches["score_u8"] < 1 or launches["prefilter_any8"]:
            raise SystemExit(f"cli MX000001 x genome: launches {launches}")
        log("cli", run="MX000001 x genome", rows=len(pos), equal_scanner=True,
            launches=launches, wall_s=f"{wall:.3f}", cli_timing=json.dumps(timing))

        # --mesh (the default mesh: every card): the same TSVs through the
        # sharded scanners, the prefilter and K2 launched
        for what, mfile, extra, want_tsv, kernel in (
                ("database x genome", db_file, ["-P", str(DB_PVALUE), "--reverse"], genome_tsv,
                 "prefilter_any8"),
                ("MX000001 x genome", mx_file, [], open(out).read(), "score_u8")):
            mesh_out = os.path.join(work, "mesh.tsv")
            launches, wall, timing = run_cli(
                ["-m", mfile, "--format", "jaspar16", "-s", genome_fa, "-o", mesh_out, *extra,
                 "--mesh"], f"{what} --mesh")
            if open(mesh_out).read() != want_tsv:
                raise SystemExit(f"cli {what} --mesh: TSV != the solo TSV")
            if launches[kernel] < 1:
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
    for _, dseq in sm._bound["shards"]:
        scanner = sm._scanners[dseq.device]
        for g in scanner._groups:
            n_valid = int(np.maximum(dseq.length - sm.lengths[g["ids"]] + 1, 0).max())
            launches += -(-n_valid // scanner.SEGMENT)
    return launches


def phase_mesh(pssm, seq, ms, scanner_hits, brute) -> dict:
    """The sharded scans at full width on MESH_SHARDS x the card and on
    the default mesh: ShardedScanner (MX000001, the genome, p = 1e-5)
    equal to the Scanner's hits; sharded_argmax equal to score_max, the
    known best hit winning its tie across shards; ShardedMultiScanner
    with the database equal to MultiScanner (K3 once per group and
    shard); the four long dense motifs of phase_other_paths through the
    mesh (K1 once per motif and shard).  Walls beside the single-device
    walls of the same call.  Returns the launches of each kernel."""
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

    reset_launches()
    sc = ShardedScanner(pssm, seq, threshold=t, mesh=mesh)
    hits = sc.collect()
    torch.cuda.synchronize()
    expect("ShardedScanner.collect", launch_counts(), {"score_u8": MESH_SHARDS})
    shard_hits = sc.shard_hits.tolist()
    pos = np.asarray([h.position for h in hits], np.int64)
    bits = np.asarray([f32_bits(h.score) for h in hits], np.uint32)
    if not (np.array_equal(pos, scanner_hits[0]) and np.array_equal(bits, scanner_hits[1])):
        raise SystemExit(f"mesh: ShardedScanner != Scanner ({len(hits)} vs {len(scanner_hits[0])})")
    best = sc.max()
    if best.position != KNOWN_BEST_POS or f32_bits(best.score) != KNOWN_BEST_BITS:
        raise SystemExit(f"mesh: ShardedScanner.max {best}")
    log("mesh", check="ShardedScanner.collect == Scanner, max == the known best",
        shards=MESH_SHARDS, hits=len(hits), shard_hits=shard_hits)

    reset_launches()
    mx, am = sharded_argmax(np.asarray(pssm.data), np.asarray(seq.data), mesh=mesh)
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
               {"prefilter_any8": mesh_k3_launches(sm)})
        check_scan(f"mesh ShardedMultiScanner ({label})", got, brute)
        if not same_hits(got, want):
            raise SystemExit(f"mesh ShardedMultiScanner ({label}) != MultiScanner")
        scanners[label] = sm
        log("mesh", check="ShardedMultiScanner.scan_arrays == MultiScanner == brute force",
            mesh=label, shards=len(devices), groups=len(sm._scanners[devices[0]]._groups),
            hits=len(got[0]),
            launches=launch_counts(), first_scan_s=f"{first_s:.3f}")

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
    pairs = (
        ("ShardedScanner.collect / Scanner.collect", sc.collect, single_scanner.collect),
        ("sharded_argmax (shard + upload) / Pipeline.score_max (upload)",
         lambda: sharded_argmax(np.asarray(pssm.data), np.asarray(seq.data), mesh=mesh),
         lambda: pipe.score_max(pssm, seq)),
        (f"ShardedMultiScanner.collect_arrays / MultiScanner.scan_arrays, {len(ms.pssms)} PSSMs",
         scanners[f"{MESH_SHARDS} x {DEVICE}"].collect_arrays, lambda: ms.scan_arrays(seq)),
        ("dense ShardedMultiScanner.collect_arrays / MultiScanner.scan_arrays",
         dense.collect_arrays, lambda: single.scan_arrays(seq)),
    )
    med = statistics.median
    for op, sharded, one in pairs:
        a1, b1, b2, a2 = wall_ms(one), wall_ms(sharded), wall_ms(sharded), wall_ms(one)
        log("times", op=f"mesh walls, {MESH_SHARDS} shards on one card: {op}",
            sharded_ms=f"{min(med(b1), med(b2)):.4f}", single_ms=f"{min(med(a1), med(a2)):.4f}",
            runs=f"sharded={med(b1):.4f},{med(b2):.4f} single={med(a1):.4f},{med(a2):.4f}")
    return total


MESH_WORKER = """
import os, sys
import numpy as np
import torch
import torch.distributed as dist

rank, port, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method="tcp://localhost:" + port, world_size=2,
                        rank=rank)
sys.path.insert(0, os.getcwd())
import chip_smoke as cs
from lightmotif_tpu_torch.parallel import (ShardedMultiScanner, ShardedScanner,
                                           make_genome_mesh, sharded_argmax)

torch.cuda.set_device(0)
pssm, seq = cs.build_inputs()
pssms, ths, _ = cs.synthetic_database(cs.DB_MOTIFS, cs.DB_SEED)
mesh = make_genome_mesh([cs.DEVICE] * (cs.MESH_SHARDS // 2))
cs.reset_launches()
t = pssm.score_distribution().score(1e-5)
hits = ShardedScanner(pssm, seq, threshold=t, mesh=mesh).collect()
mx, am = sharded_argmax(np.asarray(pssm.data), np.asarray(seq.data), mesh=mesh)
sm = ShardedMultiScanner(pssms, thresholds=ths, mesh=mesh)
mo, pos, sc = sm.scan_arrays(seq)
torch.cuda.synchronize()
launches = cs.launch_counts()
np.savez(out, pos=np.asarray([h.position for h in hits], np.int64),
         bits=np.asarray([cs.f32_bits(h.score) for h in hits], np.uint32),
         argmax=np.asarray([cs.f32_bits(mx), am], np.int64),
         mo=mo, mpos=pos, msc=sc, shard_hits=sm.shard_hits,
         launches=np.asarray([launches[k] for k in sorted(launches)], np.int64),
         names=np.asarray(sorted(launches)),
         jax=np.asarray(sorted(m for m in sys.modules
                               if m.split(".")[0] in ("jax", "lightmotif_tpu"))))
dist.destroy_process_group()
"""


def phase_mesh_procs(scanner_hits, brute) -> None:
    """Two processes joined with gloo, both on the card, each owning
    MESH_SHARDS / 2 shards: over the genome (ShardedScanner and
    sharded_argmax) and the database (ShardedMultiScanner); their merged
    hits must equal the single-process hits, and both must report the
    known argmax and the same per-shard hit counts."""
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
    outs = [os.path.join(work, f"rank{r}.npz") for r in range(2)]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-c", MESH_WORKER, str(r), port, outs[r]],
                              cwd=root, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    try:
        for r, p in enumerate(procs):
            text, _ = p.communicate(timeout=600)
            if p.returncode != 0:
                raise SystemExit(f"mesh_procs: rank {r} exit {p.returncode}\n{text[-4000:]}")
        wall = time.perf_counter() - t0
        res = [dict(np.load(o)) for o in outs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(work, ignore_errors=True)
    pos = np.concatenate([r["pos"] for r in res])
    bits = np.concatenate([r["bits"] for r in res])
    order = np.argsort(pos, kind="stable")
    if not (np.array_equal(pos[order], scanner_hits[0])
            and np.array_equal(bits[order], scanner_hits[1])):
        raise SystemExit("mesh_procs: the merged ShardedScanner hits != Scanner")
    for r in res:
        if r["argmax"].tolist() != [KNOWN_BEST_BITS, KNOWN_BEST_POS] or r["jax"].size:
            raise SystemExit(f"mesh_procs: argmax {r['argmax'].tolist()}, jax {r['jax']}")
    if not np.array_equal(res[0]["shard_hits"], res[1]["shard_hits"]):
        raise SystemExit("mesh_procs: the ranks' per-shard counts differ")
    mo = np.concatenate([r["mo"] for r in res])
    mpos = np.concatenate([r["mpos"] for r in res])
    msc = np.concatenate([r["msc"] for r in res])
    order = np.lexsort((mpos, mo))
    check_scan("mesh_procs ShardedMultiScanner", (mo[order], mpos[order], msc[order]), brute)
    launches = [dict(zip(r["names"].tolist(), r["launches"].tolist())) for r in res]
    if any(min(n["score_u8"], n["score_f32"], n["prefilter_any8"]) < 1 for n in launches):
        raise SystemExit(f"mesh_procs: a kernel of the path never launched: {launches}")
    log("mesh_procs", processes=2, backend="gloo", device=str(DEVICE),
        shards_each=MESH_SHARDS // 2, scanner_hits=[len(r["pos"]) for r in res],
        database_hits=[len(r["mo"]) for r in res], merged_equal_single=True,
        argmax=KNOWN_BEST_POS, shard_hits=res[0]["shard_hits"].tolist(),
        launches=launches, wall_s=f"{wall:.3f}")


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
    return out


def phase_database_times(ms, seq) -> tuple:
    """K3 at a database group's shape beside its plain version, the
    database scan's steady-state wall and its split by stage."""
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
    lanes = group["t_eff"].shape[0]
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

    walls = []
    for _ in range(RUNS + 1):
        t0 = time.perf_counter()
        ms.scan_arrays(seq)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall = statistics.median(walls[1:])
    log("times", op=f"MultiScanner.scan_arrays wall, steady state, {len(ms.pssms)} PSSMs",
        ms=f"{wall:.4f}", p90_ms=f"{sorted(walls[1:])[int(0.9 * RUNS)]:.4f}",
        pssm_gpos_s=f"{len(ms.pssms) * len(seq) / wall / 1e6:.3f}")

    # split by stage, on the real path: the scanner's timing hook records
    # a CUDA event as each stage's work is queued, and an interval counts
    # to the stage that ends it (host gaps inside a stage included).  The
    # same run is profiled: device busy = the sum of its kernels' device
    # times, host = the run's wall minus that
    from torch.profiler import ProfilerActivity, profile

    stages: dict = {}
    counts: dict = {}
    marks = []

    def mark(stage, n):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((stage, ev))
        counts[stage] = counts.get(stage, 0) + n

    ms.mark = mark
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        mark("start", 0)
        ms.scan_arrays(seq)
        torch.cuda.synchronize()
        run_wall = (time.perf_counter() - t0) * 1e3
    ms.mark = None
    for (_, a), (stage, b) in zip(marks, marks[1:]):
        stages[stage] = stages.get(stage, 0.0) + a.elapsed_time(b)
    busy = sum(getattr(e, "self_device_time_total", 0.0) for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA) / 1e3
    log("times", op="database scan by stage (one profiled run, CUDA events)",
        **{f"{k}_ms": f"{v:.4f}" for k, v in stages.items()},
        run_wall_ms=f"{run_wall:.4f}",
        device_busy_ms=f"{busy:.4f}" if busy else "not measured",
        host_ms=f"{run_wall - busy:.4f}" if busy else "not measured",
        idle_share=f"{1 - busy / run_wall:.4f}" if busy else "not measured",
        **{f"n_{k}": v for k, v in counts.items() if k not in ("start", "k3")})
    return entry


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
    lanes = group["t_eff"].shape[0]
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
    argmax) beside a per-record ``Pipeline.score_max`` loop, and
    MultiBatchScanner (prepare + rebind + collect_arrays)."""
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
    lanes = np.zeros(group["t_eff"].shape[0], np.int32)
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
    bits_bytes = chunk.shape[0] * (1 + 4 * group["t_eff"].shape[0] // 16)
    bound_ms, bound_by = max(k3_bound, (bits_bytes / HBM_BYTES_PER_S * 1e3, "bytes"))
    out["prefilter_bits"] = {"source": K3_SOURCE, "replaces": P9_REPLACES,
                             "launches": launches["P9"], "max_abs_err": 0.0,
                             "ms": p9["bits_ms"], "plain_ms": p9["plain_ms"],
                             "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    log("probes", launches=launches)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    phase_card()
    phase_imports()
    phase_build()
    phase_sass()
    pssm, seq = build_inputs()
    errs = phase_kernels(pssm, seq)
    cases = list(prefilter_cases())
    errs["prefilter_any8"] = phase_k3(cases)
    errs.update(phase_k4k5(cases, seq))
    del cases
    launches, scanner_hits = phase_main_path(pssm, seq)
    ms, launches["prefilter_any8"], brute, counts = phase_database(seq)
    db, groups5, launches["prefilter_any16"], launches["prefilter_any"] = phase_modes(
        ms, seq, brute)
    phase_other_paths(seq)
    records, br, mbs, batch_hits = phase_batch(pssm, seq, ms)
    phase_cli(pssm, seq, ms, counts, records, batch_hits, scanner_hits, brute)
    # the last slice's paths: each kernel's launches there join its count
    phase_tfmpvalue(pssm)
    launches["score_f32"] += phase_sampler()
    phase_batch_sampler()
    for name, n in phase_mesh(pssm, seq, ms, scanner_hits, brute).items():
        launches[name] += n
    phase_mesh_procs(scanner_hits, brute)
    times = phase_times(pssm, seq)
    times["prefilter_any8"] = phase_database_times(ms, seq)
    times.update(phase_mode_times(ms, seq, db, groups5))
    phase_batch_times(pssm, records, br, mbs)
    phase_host_cost(pssm, seq)
    probe_entries = phase_probes(ms, seq, times)
    probe_entries.update(phase_score_probes(pssm, seq, ms, times))
    sources = {"score_f32": (SOURCE, REPLACES), "score_u8": (SOURCE, REPLACES),
               "prefilter_any8": (K3_SOURCE, K3_REPLACES),
               "prefilter_any": (K3_SOURCE, K4_REPLACES),
               "prefilter_any16": (K3_SOURCE, K5_REPLACES)}
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


if __name__ == "__main__":
    sys.exit(main())
