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
5. times on the card (CUDA events, median of 15 samples after a
   warm-up), each kernel beside its plain version: device time per
   launch (20 launches queued behind a GPU spin), and one call with the
   host's launch cost; then ``score_max`` and the Scanner's wall time.

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

SOURCE = "lightmotif_tpu_torch/ops/csrc/score.cu"
REPLACES = "lightmotif_tpu/ops/kernels.py:73"


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
        nvcc_seconds=f"{info['seconds']:.3f}", library=info["path"].name)
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line:
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
        sd = torch.from_numpy(s).cuda()
        errs["score_f32"] = max(errs["score_f32"], check_kernel(
            "score_f32", kernels.score_f32, torch_ops.score_f32, sd,
            torch.from_numpy(w).cuda(), n_scores))
        errs["score_u8"] = max(errs["score_u8"], check_kernel(
            "score_u8", kernels.score_u8, torch_ops.score_u8, sd,
            torch.from_numpy(d).cuda(), n_scores))
        log("kernels", k=k, m=m, length=length, n_scores=n_scores, equal=True)

    # the shapes of the main path: the padded genome, and the Scanner's
    # one-segment chunk
    dseq = DeviceSequence(seq, torch.device("cuda"))
    m = len(pssm)
    n = len(seq) - m + 1
    w = torch.from_numpy(pssm.data).cuda()
    d = torch.from_numpy(pssm.to_discrete().data).cuda()
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

    kernels.reset_launches()
    scores = pssm.score(seq).unstripe().data
    if not (scores.shape == host.shape and np.array_equal(scores, host)):
        raise SystemExit("pssm.score != score_host over the genome")
    log("main", check="full-genome bit parity", windows=n)

    mx, am = Pipeline("cuda").score_max(pssm, seq)
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


def time_cuda(fn, repeat: int = 1) -> float:
    """Median milliseconds of one ``fn()`` over RUNS samples after a
    warm-up, timed with CUDA events around ``repeat`` calls.

    With ``repeat > 1`` the calls queue up behind a GPU spin, so the
    events time the device work alone and not the host's launch cost
    (which is larger than a genome-sized scoring kernel).
    """
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
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

    dseq = DeviceSequence(seq, torch.device("cuda"))
    n = len(seq) - len(pssm) + 1
    w = torch.from_numpy(pssm.data).cuda()
    d = torch.from_numpy(pssm.to_discrete().data).cuda()
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

    pipe = Pipeline("cuda")
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.cuda.set_device(0)
    phase_card()
    phase_build()
    pssm, seq = build_inputs()
    errs = phase_kernels(pssm, seq)
    launches = phase_main_path(pssm, seq)
    times = phase_times(pssm, seq)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": times[name][0], "plain_ms": times[name][1]}
        for name in ("score_f32", "score_u8")]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
