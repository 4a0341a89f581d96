"""The port's sharded scans across two processes.

Two Python processes, joined with ``torch.distributed`` (gloo, a free
local port), each own 4 CPU shards of one 8-shard genome.  Each returns
the hits of its own shards; merged, they equal the single-process scan,
and both report the same ``sharded_argmax``, ``ShardedScanner.max`` and
per-shard hit counts.  Each process has its own time limit, so a hang
fails the test instead of the suite.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys
import textwrap

import numpy as np

import lightmotif_tpu_torch as tlm
from lightmotif_tpu_torch.ops.pipeline import Pipeline
from lightmotif_tpu_torch.scanner import MultiScanner, Scanner

from .data import PATTERNS

ROOT = pathlib.Path(__file__).resolve().parents[1]

_WORKER = textwrap.dedent(
    """
    import json, sys
    import numpy as np
    import torch.distributed as dist

    rank, port = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method="tcp://localhost:" + port,
                            world_size=2, rank=rank)
    import lightmotif_tpu_torch as lm
    from lightmotif_tpu_torch.parallel import (
        ShardedMultiScanner, ShardedScanner, make_genome_mesh, sharded_argmax,
        sharded_scan)

    cm = lm.CountMatrix.from_sequences(lm.EncodedSequence.encode(p) for p in @PATTERNS@)
    pssm = cm.to_freq(0.1).to_weight(None).to_scoring()
    dm = pssm.to_discrete()
    genome = np.random.default_rng(42).integers(0, 4, size=60_000).astype(np.uint8)
    mesh = make_genome_mesh(["cpu"] * 4)
    positions, scores = sharded_scan(np.asarray(pssm.data), np.asarray(dm.data), genome,
                                     threshold=-5.0, t_scaled=dm.scale(-5.0), mesh=mesh,
                                     pad_unit=256)
    gmax, garg = sharded_argmax(np.asarray(pssm.data), genome, mesh=mesh, pad_unit=256)
    scanner = ShardedScanner(pssm, lm.EncodedSequence(genome), threshold=-5.0, mesh=mesh,
                             pad_unit=256)
    own = scanner.collect()
    shard_hits = scanner.shard_hits.tolist()
    best = scanner.max()
    sms = ShardedMultiScanner([pssm, pssm.reverse_complement()], thresholds=-5.0,
                              mesh=mesh)
    mhits = sms.scan(genome[:30_000])
    bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "lightmotif_tpu"))
    print("RESULT" + json.dumps({
        "rank": rank,
        "hits": [[int(p), float(s)] for p, s in zip(positions, scores)],
        "own": [[h.position, h.score] for h in own],
        "shard_hits": shard_hits,
        "argmax": [gmax, garg],
        "max": [best.position, best.score],
        "mhits": [[h.motif, h.position, h.score] for h in mhits],
        "multi_shard_hits": sms.shard_hits.tolist(),
        "jax_modules": bad,
    }), flush=True)
    dist.destroy_process_group()
    """
).replace("@PATTERNS@", repr(PATTERNS))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def f32(x) -> int:
    return int(np.float32(x).view(np.uint32))


def test_two_processes_equal_one():
    port = str(_free_port())
    env = dict(os.environ, PYTHONPATH=str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, str(rank), port],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=ROOT)
             for rank in range(2)]
    results = {}
    try:
        for p in procs:
            out, _ = p.communicate(timeout=180)
            assert p.returncode == 0, out[-3000:]
            for line in out.splitlines():
                if line.startswith("RESULT"):
                    rec = json.loads(line[len("RESULT"):])
                    results[rec["rank"]] = rec
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    assert set(results) == {0, 1}

    cm = tlm.CountMatrix.from_sequences(tlm.EncodedSequence.encode(p) for p in PATTERNS)
    pssm = cm.to_freq(0.1).to_weight(None).to_scoring()
    genome = np.random.default_rng(42).integers(0, 4, size=60_000).astype(np.uint8)
    seq = tlm.EncodedSequence(genome)
    want = [(h.position, f32(h.score)) for h in Scanner(pssm, seq, -5.0, device="cpu")]
    for key in ("hits", "own"):
        got = sorted((p, f32(s)) for rec in results.values() for p, s in rec[key])
        assert got == want and want
    # each process holds its own block of shards, and the hits split between them
    assert results[0]["hits"] and results[1]["hits"]
    assert max(p for p, _ in results[0]["hits"]) < min(p for p, _ in results[1]["hits"])
    # the counters, the argmax and the max are the same on both processes
    for key in ("shard_hits", "argmax", "max", "multi_shard_hits"):
        assert results[0][key] == results[1][key], key
    counts = results[0]["shard_hits"]
    assert len(counts) == 8 and sum(counts) == len(want)
    assert counts[:4] != [0] * 4 and sum(counts[:4]) == len(results[0]["own"])
    mx, am = Pipeline("cpu").score_max(pssm, seq)
    assert results[0]["argmax"][1] == am and f32(results[0]["argmax"][0]) == f32(mx)
    best = Scanner(pssm, seq, -5.0, device="cpu").max()
    assert results[0]["max"][0] == best.position and f32(results[0]["max"][1]) == f32(best.score)

    sub = tlm.EncodedSequence(genome[:30_000])
    mo, pos, sc = MultiScanner([pssm, pssm.reverse_complement()], sub, -5.0,
                               device="cpu").scan_arrays(sub)
    want_m = list(zip(mo.tolist(), pos.tolist(), (f32(s) for s in sc)))
    got_m = sorted((m, p, f32(s)) for rec in results.values() for m, p, s in rec["mhits"])
    assert got_m == want_m and want_m
    assert sum(results[0]["multi_shard_hits"]) == len(want_m)
    assert results[0]["jax_modules"] == results[1]["jax_modules"] == []
