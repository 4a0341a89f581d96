"""One run of one cell of the benchmark of ``lightmotif_tpu_torch``.

A cell (``BENCHMARK.json``'s ``workloads``) names a configuration (a
deployment: the motif database, its alphabet (one of the program's,
named by its symbols), strands and background, and the sequences or
record sets it is scanned over, ``configs/<name>.json``) and a traffic
mix (``traffic/<name>.json``: the p-value, how many distinct sequences
or record sets stream past, the loop, the scans checked and traced).
The limits of its comparison are in ``limits/<workload>.json``; each
metric is read by ``metrics/<name>.py``.
A new cell, mix or metric is a new file.

A run:

1. set-up, from process start: the inputs made from the seed
   (:mod:`.data`); the scoring matrices and thresholds through the
   program's public chain (span ``matrix.thresholds``); a
   ``MultiScanner`` (a ``MultiBatchScanner`` for record sets), whose
   first scan packs the database and ratchets its capacities (span
   ``scanner.first_scan``), and one scan of every other sequence or set,
   so that every shape the window uses has run;
2. the window: a closed loop of one client scanning the sequences in
   turn with ``MultiScanner.scan_arrays`` on host sequences (record sets
   with ``MultiBatchScanner.rebind`` then ``collect_arrays``), each scan
   binding a sequence the scanner does not hold (upload, eager issue,
   hits to the host), for ``seconds``; with ``trace`` a slice of it runs
   under ``torch.profiler`` (:mod:`.trace`);
3. the memory peak is read, the program's state freed, and the scans
   drawn from the seed are compared with the plain reference
   (:mod:`.reference`, :mod:`.check`) on the same device.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from . import check, data, reference, trace as tracing

HERE = Path(__file__).resolve().parent

#: Top-level module names that may not be loaded in the measured process.
FORBIDDEN = ("jax", "jaxlib", "flax", "lightmotif_tpu")


class NoResult(Exception):
    """The run cannot give a result; the message says why."""


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(root: Path, workload: str, bench: Path = HERE) -> SimpleNamespace:
    """The workload's entry, configuration, traffic, limits and metrics,
    found by name from ``root/BENCHMARK.json`` (traffic and limits under
    ``bench``)."""
    spec = load_json(root / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise NoResult(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])

    def applies(metric):
        return workload in metric.get("workloads", [workload])

    return SimpleNamespace(
        entry=entry,
        config=load_json(root / conf["file"]),
        traffic=load_json(bench / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(bench / "limits" / f"{workload}.json"),
        end_to_end=[m for m in spec["end_to_end"] if applies(m)],
        per_layer=[m for m in spec["per_layer"] if applies(m)])


def reader(name: str):
    """The ``read(run)`` of ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"motifbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def alphabet_of(config: dict):
    """The program's alphabet whose symbols are ``config["alphabet"]``."""
    from lightmotif_tpu_torch import DNA, PROTEIN

    for alphabet in (DNA, PROTEIN):
        if alphabet.symbols == config["alphabet"]:
            return alphabet
    raise NoResult(f"the program has no alphabet {config['alphabet']!r}")


def strands_of(config: dict) -> int:
    """``database.strands``: 1, or 2 for an alphabet with a complement."""
    strands = int(config["database"]["strands"])
    if strands not in (1, 2) or (strands == 2 and "complement" not in config):
        raise NoResult(f"strands {strands} with complement {config.get('complement')!r}")
    return strands


def program_chain(counts: list, config: dict, pvalue: float) -> tuple:
    """The database through the program's public chain: the scoring
    matrices against the configuration's background (``None`` where it
    is uniform), and each threshold at ``pvalue``; for 2 strands the
    reverse complements after them at the forward thresholds (as the
    CLI's ``--reverse``)."""
    from lightmotif_tpu_torch import Background, CountMatrix

    alphabet = alphabet_of(config)
    db = config["database"]
    freqs = np.asarray(db["background"], np.float32)
    background = (None if np.array_equal(freqs, Background.uniform(alphabet).frequencies)
                  else Background(alphabet, freqs))
    pseudo = float(db["pseudocount"])
    fwd = [CountMatrix(alphabet, c).to_freq(pseudo).to_weight(background).to_scoring()
           for c in counts]
    ths = [p.score_distribution().score(pvalue) for p in fwd]
    if strands_of(config) == 1:
        return fwd, np.asarray(ths, np.float32)
    pssms = fwd + [p.reverse_complement() for p in fwd]
    return pssms, np.asarray(ths + ths, np.float32)


def draw_checks(traffic: dict, seed: int) -> dict:
    """``{sequence: occurrence}``: the scans compared with the reference,
    drawn from the seed (the last occurrence stands in for one the
    window does not reach)."""
    rng = np.random.default_rng(int(seed))
    n_seq = int(traffic["sequences"])
    chosen = rng.choice(n_seq, size=int(traffic["check_scans"]), replace=False)
    return {int(s): int(rng.integers(0, int(traffic["check_draw"]))) for s in chosen}


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool, *,
        t_start: float, device=None, control: bool = False, log=None,
        bench: Path = HERE) -> dict:
    """One run; returns the result object (see ``run.py``).  ``device``
    ``None`` asks for the CUDA cards the cell names, and raises
    :class:`NoResult` without them."""
    log = log or (lambda *a: print(*a, file=sys.stderr, flush=True))
    c = cell(root, workload, bench)
    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(c.entry["chips"]):
            raise NoResult(f"the cell needs {c.entry['chips']} CUDA device(s); "
                           f"found {torch.cuda.device_count()}")
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    device = torch.device(device)
    imports_s = time.perf_counter() - t_start
    from lightmotif_tpu_torch import EncodedSequence
    from lightmotif_tpu_torch.batch import MultiBatchScanner
    from lightmotif_tpu_torch.ops import multi
    from lightmotif_tpu_torch.scanner import MultiScanner

    conf, traffic = c.config, c.traffic
    alphabet = alphabet_of(conf)
    k = alphabet.size
    if traffic["loop"] != "closed" or int(traffic["clients"]) != 1:
        raise NoResult("the harness drives a closed loop of one client")
    pvalue = float(traffic["pvalue"])
    records = "records" in conf["sequence"]
    t0 = time.perf_counter()
    counts = data.database_counts(conf["database"], k,
                                  data.generator(conf["database"]["seed"], device))
    g = data.generator(seed, device)
    draw = data.record_sets if records else data.sequences
    codes = draw(conf["sequence"], int(traffic["sequences"]), k,
                 conf["database"]["background"], g)
    if records:
        seqs = [[EncodedSequence(r, alphabet) for r in rs] for rs in codes]
    else:
        seqs = [EncodedSequence(row, alphabet) for row in codes]
    inputs_s = time.perf_counter() - t0

    t0 = time.perf_counter()
    pssms, thresholds = program_chain(counts, conf, pvalue)
    spans = {"matrix.thresholds": time.perf_counter() - t0}
    if records:
        scanner = MultiBatchScanner(pssms, thresholds=thresholds, device=device)
        replays = scanner._scanner.replays

        def scan(s):
            return scanner.rebind(seqs[s]).collect_arrays()
    else:
        scanner = MultiScanner(pssms, thresholds=thresholds, device=device)
        replays = scanner.replays

        def scan(s):
            return scanner.scan_arrays(seqs[s])
    t0 = time.perf_counter()
    scan(0)
    spans["scanner.first_scan"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for s in range(1, len(seqs)):
        scan(s)
    sync(device)
    warm_s = time.perf_counter() - t0
    cuda = device.type == "cuda"
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    multi.reset_reruns()
    graphs_before = (replays.captured, replays.replayed)
    checks = draw_checks(traffic, seed)
    kept, last, final = {}, {}, [None]
    scans = []  # (sequence, wall seconds, hits)
    seen = [0] * len(seqs)
    slice_ = None
    n_trace = int(traffic["trace_scans"]) if trace else 0

    def one(i):
        s = i % len(seqs)
        t = time.perf_counter()
        out = scan(s)
        wall = time.perf_counter() - t
        scans.append((s, wall, len(out[-1])))
        final[0] = (s, out)
        if s in checks:
            last[s] = out
            if seen[s] == checks[s]:
                kept[s] = out
        seen[s] += 1

    # each scan's bases, by record
    bases = [[len(r) for r in c] if records else [len(c)] for c in codes]
    setup_s = time.perf_counter() - t_start
    w0 = time.perf_counter()
    i = 0
    if n_trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
        with profile(activities=acts, with_stack=True) as prof:
            one(i)  # the tracer may miss a session's first operations
            i += 1
            with record_function(tracing.RANGE):
                for _ in range(n_trace):
                    one(i)
                    i += 1
            sync(device)
        traced = [bases[s] for s, _, _ in scans[1 : 1 + n_trace]]
    while time.perf_counter() - w0 < seconds:
        one(i)
        i += 1
    window_s = time.perf_counter() - w0
    sync(device)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    graphs = (replays.captured - graphs_before[0], replays.replayed - graphs_before[1])
    if n_trace:
        slice_ = tracing.Slice(tracing.events_of(prof), traced,
                               device.index if cuda else 0)

    lengths = np.asarray([len(p) for p in pssms])
    live = np.asarray([float(np.max(np.where(np.isfinite(p.data), p.data, -np.inf), axis=1).sum())
                       >= t for p, t in zip(pssms, thresholds)])
    record = SimpleNamespace(
        setup_s=setup_s, window_s=window_s, pssms=len(pssms),
        scans=[{"bp": sum(bases[s]), "wall_s": w, "hits": h} for s, w, h in scans],
        spans=spans, counters={"reruns": sum(multi.RERUNS.values())},
        peak_bytes=window_peak, trace=slice_, k=k, lengths=lengths,
        # the motifs the prefilter scans: those that can reach their
        # thresholds and that the program does not route to its dense path
        prefiltered=live & (lengths <= MultiScanner.dense_m_limit(k)))
    wanted = c.per_layer if trace else c.end_to_end
    metrics = {}
    for m in wanted:
        value = reader(m["name"])(record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    log(f"setup_s={setup_s!r} imports_s={imports_s!r} inputs_s={inputs_s!r} "
        f"chain_s={spans['matrix.thresholds']!r} first_scan_s={spans['scanner.first_scan']!r} "
        f"other_warm_scans_s={warm_s!r}")
    log(f"scans={len(scans)} window_s={window_s!r} graphs_captured={graphs[0]} "
        f"graphs_replayed={graphs[1]} reruns={record.counters['reruns']}")

    # the program's state goes before the reference runs
    prog_ths = thresholds
    prog_mats = [np.asarray(p.data, np.float32) for p in pssms]
    del scanner, scan, replays, pssms
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    outputs = {s: kept.get(s, last[s]) for s in checks if s in last}
    if not outputs:  # the window reached none of the drawn sequences
        outputs = {final[0][0]: final[0][1]}
    t0 = time.perf_counter()
    numbers, ctrl = compare(conf, traffic, counts, codes, prog_mats, prog_ths, outputs,
                            scans, c.limits, device, control)
    log(f"reference_s={time.perf_counter() - t0!r} checked_scans={len(outputs)} "
        f"hits_per_scan={np.mean([h for _, _, h in scans])!r}")
    correct = check.verdict(numbers, c.limits)
    failed = numbers["missed_hits"] + numbers["extra_hits"] > 0
    bad = forbidden_modules()
    if bad:
        raise NoResult(f"modules loaded in the measured process: {bad}")
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(max(setup_peak, window_peak))}
    result = {"correct": bool(correct), "attempted": len(scans),
              "failed": int(numbers["count_drift"]) + (len(outputs) if failed else 0),
              "metrics": metrics, "device": dev}
    if slice_ is not None:
        dev["busy_s"] = slice_.busy_s
        dev["window_s"] = slice_.window_s
        result["breakdown"] = {"device_ops": slice_.top_ops(), "idle_gaps": slice_.idle_gaps()}
        if cuda:
            log("card " + power_limit())
    if control:
        result["control"] = ctrl
    result["checks"] = {n: {"value": numbers[n], "limit": c.limits[n]} for n in check.NAMES}
    for line in check.lines(numbers, c.limits):
        log(line)
    return result


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "power.limit not read"


def compare(conf, traffic, counts, codes, prog_mats, prog_ths, outputs, scans, limits,
            device, control) -> tuple:
    """The comparison's numbers for the program, and with ``control`` the
    control's (the reference in bfloat16 in the program's place)."""
    k = len(conf["alphabet"])
    # the published chain's background is float32
    bg = np.asarray(conf["database"]["background"], np.float32).astype(np.float64)
    pvalue = float(traffic["pvalue"])

    def chain(dtype):
        fwd = reference.scoring_matrices(counts, conf["database"]["pseudocount"], bg, dtype)
        t = reference.thresholds(fwd, bg, pvalue, device)
        if strands_of(conf) == 1:
            return fwd, t
        perm = reference.complement_permutation(conf["alphabet"], conf["complement"])
        return fwd + reference.reverse_complements(fwd, perm), np.concatenate([t, t])

    mats, t_ref = chain(torch.float32)
    windows = reference.Windows(mats, k, k - 1, device)
    seqs, places = {}, {}
    for s in outputs:
        if "records" in conf["sequence"]:
            joined, *places[s] = reference.join_records(
                codes[s], int(windows.lengths.max()) - 1, k - 1)
        else:
            joined = codes[s]
        seqs[s] = torch.from_numpy(np.ascontiguousarray(joined)).to(device)

    def program_hits(s, seq):
        if s not in places:
            return (*outputs[s], 0)
        return check.place_hits(outputs[s], *places[s], windows.lengths)

    def judged(got_mats, got_t, hits_of) -> dict:
        out = {"matrix_gap": check.matrix_gap(got_mats, mats),
               "threshold_gap": check.threshold_gap(got_t, t_ref),
               "score_gap": 0.0, "missed_hits": 0, "extra_hits": 0, "count_drift": 0}
        if np.shape(got_t) != t_ref.shape:  # other matrices: threshold_gap is inf
            got_t = t_ref
        for s, seq in sorted(seqs.items()):
            *hits, misplaced = hits_of(s, seq)
            got = check.judge_hits(windows, seq, hits, t_ref, got_t,
                                   float(limits["score_gap"]))
            out["score_gap"] = max(out["score_gap"], got["score_gap"])
            out["missed_hits"] += got["missed_hits"]
            out["extra_hits"] += got["extra_hits"] + misplaced
        return out

    numbers = judged(prog_mats, prog_ths, program_hits)
    first = {}
    for s, _, h in scans:
        numbers["count_drift"] += first.setdefault(s, h) != h
    ctrl = None
    if control:
        c_mats, c_t = chain(torch.bfloat16)
        c_t = torch.from_numpy(c_t).bfloat16().float().numpy()
        c_windows = reference.Windows(c_mats, k, k - 1, device, dtype=torch.bfloat16)
        ctrl = judged(c_mats, c_t, lambda s, seq: (*reference.scan(c_windows, seq, c_t), 0))
    return numbers, ctrl
