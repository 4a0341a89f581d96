#!/usr/bin/env python
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line of output each (any failure exits non-zero):

1. the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions;
2. build: ``nvcc`` compiles ``lightmotif_tpu_torch/ops/csrc/*.cu`` for
   ``sm_90a``;
3. each kernel against its plain PyTorch version on the card
   (``torch.equal``): DNA and protein tables, random sequences with
   wildcards, ragged ``n_scores``, and the main path's own shapes;
4. the main path at full size: an E. coli-sized genome (4,641,652 bp,
   seed 0xECC011) against PRODORIC MX000001 -- full-genome bit parity
   of ``pssm.score`` with the sequential host oracle, the known best
   hit (position 3,254,602, f32 bits 0x4197E448, which must win the
   exact tie with position 2,558,379), and the two-pass ``Scanner`` at
   p = 1e-5 against the host brute force, in one segment and in five;
   both kernels must have been launched by this phase;
5. K3, the multi-motif prefilter, against its plain version
   (``torch.equal`` on every window that fits): DNA groups of 16, 256
   (ragged lengths) and 2,048 motif lanes with m_max 2 to 128 (1, 2, 3
   and 8 contraction blocks), protein groups with m_max 5 and 32,
   never-pass lanes, sequences with wildcard runs;
6. the database path at full size: a seeded synthetic stand-in for
   JASPAR2024 (2,346 DNA motifs of lengths 5-35, 20 Dirichlet(0.5)
   sites each, pseudocount 0.1, both strands = 4,692 PSSMs, thresholds
   at p = 1e-6) scanned over the genome by ``MultiScanner.scan_arrays``
   in one segment and in five, each equal to a per-PSSM brute force on
   the card (K1 + threshold: positions and f32 bits, -0.0 read as
   +0.0); K3 must have been launched by the scan;
7. the dense path (four DNA motifs of m 129-257) and a protein database
   (200 motifs of m 5-40 over 1,000,000 residues) against the same
   brute force; each scan must have launched K1 once per dense motif
   and K3 once per motif group;
8. times on the card (CUDA events, median of 15 samples after a
   warm-up), each kernel beside its plain version: device time per
   launch (launches queued behind a GPU spin), and one call with the
   host's launch cost; then ``score_max``, the Scanner's wall time, K3
   at a database group's shape, the database scan's steady-state wall
   and, from one more run through the scanner's timing hook and
   ``torch.profiler``, its split by stage, device-busy time and host
   time.

The line before the last is a JSON object with one entry per kernel;
the last line is ``{"ok": true, "device": {...}}``.  There is no CPU
path: without a CUDA device the script fails.
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

DB_MOTIFS = 2346  # JASPAR2024 CORE, as tests/test_io.py pins it
DB_SEED = 0x1A5BA2
DB_PVALUE = 1e-6
PROTEIN_LENGTH = 1_000_000
PROTEIN_MOTIFS = 200
PROTEIN_PVALUE = 1e-5


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


def phase_card() -> None:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    log("card", torch=torch.__version__, cuda=torch.version.cuda,
        device=repr(torch.cuda.get_device_name(0)),
        count=torch.cuda.device_count())


def phase_build() -> None:
    from lightmotif_tpu_torch.ops import build

    t0 = time.perf_counter()
    info = build.build_info()
    build.library()
    log("build", seconds=f"{time.perf_counter() - t0:.3f}",
        nvcc_seconds=f"{info['seconds']:.3f}",
        libraries=",".join(p.name for p in info["paths"]))
    for line in info["log"].splitlines():
        if "entry function" in line or "registers" in line or "spill" in line:
            print("  ptxas:", line.strip(), flush=True)


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
    cases = [(5, 1), (5, 15), (5, 33), (5, 129), (21, 10), (21, 40)]
    for k, m in cases:
        length = int(rng.integers(50_000, 120_000))
        s = rng.integers(0, k, size=length).astype(np.uint8)
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


def phase_main_path(pssm, seq) -> dict:
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
    return launches


def synthetic_motifs(rng, alphabet, lengths, sites: int = 20):
    """Scoring matrices of ``sites`` aligned sites each: every column's
    symbol probabilities are drawn from Dirichlet(0.5) and its counts
    from them; pseudocount 0.1, uniform background."""
    from lightmotif_tpu_torch import CountMatrix

    k = len(alphabet.symbols)
    out = []
    for m in lengths:
        probs = rng.dirichlet(np.full(k - 1, 0.5), size=int(m))
        counts = np.zeros((int(m), k), np.int64)
        counts[:, : k - 1] = [rng.multinomial(sites, row) for row in probs]
        out.append(CountMatrix(alphabet, counts).to_freq(0.1)
                   .to_weight(None).to_scoring())
    return out


def synthetic_database(n: int, seed: int):
    """A JASPAR2024-sized DNA database on both strands: (pssms, thresholds
    at DB_PVALUE).  Lengths 5-20 for about 92% of the motifs, 21-35 for
    the rest."""
    from lightmotif_tpu_torch import DNA

    rng = np.random.default_rng(seed)
    lengths = np.where(rng.random(n) < 0.92, rng.integers(5, 21, n),
                       rng.integers(21, 36, n))
    fwd = synthetic_motifs(rng, DNA, lengths)
    ths = [p.score_distribution().score(DB_PVALUE) for p in fwd]
    return (fwd + [p.reverse_complement() for p in fwd],
            np.asarray(ths + ths, np.float32))


def k3_group(pssms, thresholds):
    """The K3 inputs of one motif group, on the card, and its m_max."""
    from lightmotif_tpu_torch.ops import multi

    k = pssms[0].alphabet.size
    stack, lengths = multi.stack_motifs([p.data for p in pssms], k)
    m_max = int(lengths.max())
    g = multi.pack_motif_group(np.arange(len(pssms)), len(pssms), m_max,
                               stack, np.asarray(thresholds, np.float32), k)
    return [torch.from_numpy(a).to(DEVICE) for a in g["k3"]], m_max, g["widths"]


def phase_k3() -> float:
    """K3 against its plain version; returns the largest error."""
    from lightmotif_tpu_torch import DNA, PROTEIN
    from lightmotif_tpu_torch.ops import multi_kernel, torch_ops

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
    worst = 0.0
    for alphabet, lengths in cases:
        k = len(alphabet.symbols)
        pssms = synthetic_motifs(rng, alphabet, lengths)
        ths = [p.score_distribution().score(max(1e-3, 4.0 ** -len(p))) for p in pssms]
        ths[::7] = [1e6] * len(ths[::7])  # never-pass lanes
        args, m_max, widths = k3_group(pssms, ths)
        length = int(rng.integers(150_000, 250_000))
        s = rng.integers(0, k - 1, size=length).astype(np.uint8)
        for start in rng.integers(0, length - 300, size=30):  # wildcard runs
            s[start : start + int(rng.integers(1, 300))] = k - 1
        sd = torch.from_numpy(s).to(DEVICE)
        got = multi_kernel.prefilter_any8(sd, *args)
        want = torch_ops.prefilter_any8(sd, *args)
        torch.cuda.synchronize()
        n = length - m_max + 1
        if not torch.equal(got[:n], want[:n]):
            bad = int(torch.nonzero(got[:n] != want[:n])[0])
            raise SystemExit(f"prefilter_any8: kernel != plain at {bad} (K={k}, "
                             f"m_max={m_max}, lanes={len(lengths)}): "
                             f"{got[bad].item()} vs {want[bad].item()}")
        worst = max(worst, max_abs_err(got[:n], want[:n]))
        log("k3", k=k, m_max=m_max, lanes=len(lengths), widths=widths,
            length=length, candidates=int((want[:n] >= 0).sum()), equal=True)
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
        raise SystemExit(f"{name}: MultiScanner != brute force "
                         f"({len(mo)} hits vs {len(want[0])})")


def phase_database(seq):
    """The database path at full size; returns (scanner, its launches)."""
    from lightmotif_tpu_torch.ops import kernels, multi_kernel
    from lightmotif_tpu_torch.ops.pipeline import DeviceSequence
    from lightmotif_tpu_torch.scanner import MultiScanner

    t0 = time.perf_counter()
    pssms, ths = synthetic_database(DB_MOTIFS, DB_SEED)
    log("database", pssms=len(pssms), build_s=f"{time.perf_counter() - t0:.3f}",
        lengths=f"{min(len(p) for p in pssms)}-{max(len(p) for p in pssms)}")

    ms = MultiScanner(pssms, thresholds=ths, device=DEVICE)
    reset_launches()
    t0 = time.perf_counter()
    got = ms.scan_arrays(seq)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {**kernels.LAUNCHES, **multi_kernel.LAUNCHES}
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
    return ms, launches["prefilter_any8"]


def phase_other_paths(seq) -> None:
    """The dense path and a protein database against the brute force;
    each scan must have launched K1 once per dense motif and K3 once per
    motif group."""
    from lightmotif_tpu_torch import DNA, PROTEIN, EncodedSequence
    from lightmotif_tpu_torch.ops import kernels, multi_kernel
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
        launches = {**kernels.LAUNCHES, **multi_kernel.LAUNCHES}
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


def phase_times(pssm, seq) -> dict:
    from lightmotif_tpu_torch import Scanner
    from lightmotif_tpu_torch.ops import kernels, torch_ops
    from lightmotif_tpu_torch.ops.pipeline import DeviceSequence, Pipeline

    dseq = DeviceSequence(seq, DEVICE)
    n = len(seq) - len(pssm) + 1
    w = torch.from_numpy(pssm.data).to(DEVICE)
    d = torch.from_numpy(pssm.to_discrete().data).to(DEVICE)
    out = {}
    for name, kernel, plain, table in (
            ("score_f32", kernels.score_f32, torch_ops.score_f32, w),
            ("score_u8", kernels.score_u8, torch_ops.score_u8, d)):
        # device time per launch, in turns: plain, kernel, kernel, plain
        p1 = time_cuda(lambda: plain(dseq.data, table, n), repeat=20)
        k1 = time_cuda(lambda: kernel(dseq.data, table, n), repeat=20)
        k2 = time_cuda(lambda: kernel(dseq.data, table, n), repeat=20)
        p2 = time_cuda(lambda: plain(dseq.data, table, n), repeat=20)
        ms, plain_ms = min(k1, k2), min(p1, p2)
        out[name] = (ms, plain_ms)
        # one call as a caller sees it, host launch cost included
        call_ms = time_cuda(lambda: kernel(dseq.data, table, n))
        plain_call_ms = time_cuda(lambda: plain(dseq.data, table, n))
        log("times", kernel=name, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            gpos_s=f"{n / ms / 1e6:.3f}", plain_gpos_s=f"{n / plain_ms / 1e6:.3f}",
            runs=f"k={k1:.4f},{k2:.4f} p={p1:.4f},{p2:.4f}",
            call_ms=f"{call_ms:.4f}", plain_call_ms=f"{plain_call_ms:.4f}")

    pipe = Pipeline(DEVICE)
    ms = time_cuda(lambda: pipe.score_max(pssm, dseq))
    log("times", op="Pipeline.score_max (resident sequence)", ms=f"{ms:.4f}")
    ms = time_cuda(lambda: pipe.score_max(pssm, seq))
    log("times", op="Pipeline.score_max (with upload)", ms=f"{ms:.4f}")

    t = pssm.score_distribution().score(1e-5)
    walls = []
    for _ in range(RUNS + 1):
        t0 = time.perf_counter()
        Scanner(pssm, seq, threshold=t).collect()
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
    log("times", kernel="prefilter_any8", shape=f"{chunk.shape[0]}x{lanes} lanes, "
        f"m={group['m_max']}", equal=True, ms=f"{ms_k3:.4f}", plain_ms=f"{plain_k3:.4f}",
        runs=f"k={k1:.4f},{k2:.4f} p={p1:.4f},{p2:.4f}",
        gpos_lanes_s=f"{chunk.shape[0] * lanes / ms_k3 / 1e6:.3f}")

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
    return ms_k3, plain_k3


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    phase_card()
    phase_build()
    pssm, seq = build_inputs()
    errs = phase_kernels(pssm, seq)
    errs["prefilter_any8"] = phase_k3()
    launches = phase_main_path(pssm, seq)
    ms, launches["prefilter_any8"] = phase_database(seq)
    phase_other_paths(seq)
    times = phase_times(pssm, seq)
    times["prefilter_any8"] = phase_database_times(ms, seq)
    sources = {"score_f32": (SOURCE, REPLACES), "score_u8": (SOURCE, REPLACES),
               "prefilter_any8": (K3_SOURCE, K3_REPLACES)}
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name, (src, rep) in sources.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
