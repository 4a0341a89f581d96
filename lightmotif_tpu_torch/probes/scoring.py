"""Probes of the scoring kernel (K1/K2) on an NVIDIA Hopper card.

    python -m lightmotif_tpu_torch.probes.scoring

Counterparts of the JAX package's Pallas probes of its window-scoring
kernel, each asking the TPU probe's question of the H100's own
mechanism at the TPU probe's genome-sized shape.  Three families, each
a kernel with a plain PyTorch version here, checked with
``torch.equal`` and timed with CUDA events:

* **A, the scoring kernel's instantiations** (:data:`VARIANTS`, the
  mirror of ``LM_SCORE_VARIANTS`` in ``ops/csrc/score.cu``; wrapper
  :func:`score_variant`).  Every one is bit-exact: its plain version is
  :func:`..ops.torch_ops.score_f32` or ``score_u8``.  Which instantiation
  answers which TPU probe is :data:`PROBE_VARIANTS`: P2/P21/P23's
  one-op gathers are the warp-shuffle and ``__byte_perm`` lookups,
  P4/P24's masking is the lazy mask, P14's select chains the select
  tree (its DNA-only fast path the alphabet fixed at compile time),
  P15/P23's chains the positions per thread and their grouping,
  P16/P18's heads the side-input and direct halos, P17 the block
  geometry, P19 the table layouts; variant 0 is the first kernel, the
  baseline.
* **B, diagnostic bodies** (:data:`DIAG_MODES`, ``lm_probe_score_diag``
  in ``ops/csrc/probes.cu``; wrapper :func:`score_diag`): K1's memory
  pattern with one part of the work removed, as P2 (floor), P4 (io
  only), P5 (K2 writing uint8) and P15/P23 (noroll, nosel, addonly)
  did.  Each plain version (:func:`diag_plain`) is the formula of the
  JAX body, so a "wrong on purpose" output is still checked.
* **C, op-class chains** (:data:`CHAINS`, ``lm_probe_op_chain`` in
  ``ops/csrc/probes.cu``; wrapper :func:`op_chain`): serial and
  independent chains of one op class over a genome-sized buffer -- f32
  adds, cross-lane shifts (``__shfl_sync``, shared memory), lookups
  (shared memory, select tree, ``__byte_perm``), int8 SIMD ops and a
  256-entry byte table -- for P1, P3, P11, P12, P13 (its device
  skeletons), P20 and P22.  Plain version: :func:`chain_plain`.

P13's host half is :func:`pair_parity`: how many windows a pair table's
association changes, bit for bit.

None of these runs on a path of the package; :data:`LAUNCHES` counts
their launches apart from :data:`..ops.kernels.LAUNCHES`.  Every wrapper
runs its plain version for tensors on the CPU and its kernel for CUDA
tensors, and raises on anything else.  Run as a module, it builds the
seeded genome of ``bench.py`` and prints one JSON object per probe.
"""

from __future__ import annotations

import functools
import json
import subprocess
import sys

import numpy as np
import torch

from ..ops import kernels, torch_ops
from .prefilter import _device_kind, _equal, _stream, time_cuda

__all__ = [
    "LAUNCHES",
    "VARIANTS",
    "PROBE_VARIANTS",
    "DIAG_MODES",
    "CHAINS",
    "CHAIN_PROBES",
    "reset_launches",
    "accepts",
    "heads_for",
    "score_variant",
    "diag_plain",
    "score_diag",
    "chain_table",
    "chain_plain",
    "op_chain",
    "pair_parity",
    "run_variants",
    "run_diag",
    "run_chains",
]

#: Kernel launches of each probe wrapper since :func:`reset_launches`.
LAUNCHES = {"score_variant": 0, "probe_score_diag": 0, "probe_op_chain": 0}

#: The scoring kernel's instantiations, in the order of ``LM_SCORE_VARIANTS``
#: in ``csrc/score.cu``: (lookup, positions per thread, threads, positions
#: per block, halo form, lazy mask, persistent, blocks per SM asked of
#: the register allocation, alphabet size fixed at compile time or 0,
#: consecutive positions per group: 4 interleaves a thread's groups across
#: the warp so that each 128-bit store of a warp is contiguous).
VARIANTS = [
    ("legacy", 1, 256, 1024, "staged", 0, 0, 1, 0, 1),
    ("smem", 8, 256, 2048, "staged", 1, 0, 1, 0, 8),
    ("smem", 4, 256, 1024, "staged", 1, 0, 1, 0, 4),
    ("smem", 16, 256, 4096, "staged", 1, 0, 1, 0, 16),
    ("smem", 8, 128, 1024, "staged", 1, 0, 1, 0, 8),
    ("smem", 8, 256, 8192, "staged", 1, 0, 1, 0, 8),
    ("smem", 8, 512, 4096, "staged", 1, 0, 1, 0, 8),
    ("smem", 8, 256, 2048, "staged", 0, 0, 1, 0, 8),
    ("smem", 8, 256, 2048, "heads", 1, 0, 1, 0, 8),
    ("smem", 8, 256, 8192, "heads", 1, 0, 1, 0, 8),
    ("smem", 8, 256, 2048, "staged", 1, 1, 1, 0, 8),
    ("shfl", 8, 256, 2048, "staged", 1, 0, 1, 0, 8),
    ("shfl", 8, 256, 2048, "staged", 0, 0, 1, 0, 8),
    ("sel", 8, 256, 2048, "staged", 1, 0, 1, 0, 8),
    ("prmt", 8, 256, 2048, "staged", 1, 0, 1, 0, 8),
    ("prmt", 16, 256, 4096, "staged", 1, 0, 1, 0, 16),
    ("row2", 8, 256, 2048, "staged", 1, 0, 1, 0, 8),
    ("row4", 8, 256, 2048, "staged", 1, 0, 1, 0, 8),
    ("row4", 16, 256, 4096, "staged", 1, 0, 1, 0, 16),
    ("smem", 8, 256, 2048, "staged", 1, 0, 8, 0, 8),
    ("prmt", 8, 256, 2048, "staged", 1, 0, 8, 0, 8),
    ("smem", 8, 256, 2048, "staged", 1, 0, 1, 5, 8),
    ("smem", 8, 128, 1024, "staged", 1, 0, 1, 5, 8),
    ("row4", 8, 256, 2048, "staged", 1, 0, 1, 5, 8),
    ("prmt", 8, 256, 2048, "staged", 1, 0, 1, 5, 8),
    ("smem", 8, 256, 2048, "staged", 1, 2, 1, 5, 8),
    ("smem", 8, 256, 2048, "direct", 1, 0, 1, 5, 8),
    ("prmt", 8, 256, 2048, "direct", 1, 0, 1, 5, 8),
    ("smem", 8, 128, 1024, "staged", 1, 0, 1, 5, 4),
    ("smem", 8, 256, 2048, "staged", 1, 0, 1, 5, 4),
    ("smem", 16, 128, 2048, "staged", 1, 0, 1, 5, 4),
    ("prmt", 8, 256, 2048, "staged", 1, 0, 1, 5, 4),
    ("prmt", 16, 128, 2048, "staged", 1, 0, 1, 5, 4),
]

_LOOKUPS = ["legacy", "smem", "shfl", "sel", "prmt", "row2", "row4"]
_HALOS = ["staged", "heads", "direct"]

#: Family A: the TPU probe each instantiation answers, with the Pallas
#: call it replaces.
PROBE_VARIANTS = {
    "P2": ("experiments/f32_probe.py:138", [11, 14, 24]),
    "P4": ("experiments/f32_probe3.py:123", [12, 11]),
    "P14": ("experiments/perf_variants.py:106", [0, 13, 1, 21]),
    "P15": ("experiments/perf_variants2.py:134", [2, 1, 3, 4, 6]),
    "P16": ("experiments/perf_variants3.py:94", [8]),
    "P17": ("experiments/perf_variants3.py:154", [4, 1, 5, 6, 10, 19, 20, 22, 25, 30, 32]),
    "P18": ("experiments/perf_variants4.py:89", [9, 26, 27]),
    "P19": ("experiments/perf_variants6.py:86", [1, 16, 17, 23]),
    "P21": ("experiments/perf_variants7.py:85", [11, 15]),
    "P23": ("experiments/perf_variants8.py:91", [11, 3, 2, 18, 28, 29, 30, 31]),
    "P24": ("experiments/perf_variants10.py:98", [13, 7, 1]),
}

#: Family B: the diagnostic bodies, in the order of ``DIAG_*`` in
#: ``csrc/probes.cu``, each with the TPU probes it answers.
DIAG_MODES = ["io", "floor", "nosel", "noroll", "add", "u8out"]
DIAG_PROBES = {
    "io": ("P4", "experiments/f32_probe3.py:123"),
    "floor": ("P2", "experiments/f32_probe.py:138"),
    "nosel": ("P15", "experiments/perf_variants2.py:134"),
    "noroll": ("P15", "experiments/perf_variants2.py:134"),
    "add": ("P23", "experiments/perf_variants8.py:91"),
    "u8out": ("P5", "experiments/f32_probe3.py:174"),
}

#: Family C: the op chains, in the order of ``LM_CHAIN_VARIANTS`` in
#: ``csrc/probes.cu``: (op, steps per chain, independent chains).
CHAINS = [
    ("fadd", 0, 1), ("fadd", 14, 1), ("fadd", 28, 1), ("fadd", 64, 1), ("fadd", 8, 8),
    ("shfl", 14, 1), ("shfl", 28, 1), ("shfl", 14, 4), ("shfl", 7, 4),
    ("smem", 14, 1), ("smem", 28, 1),
    ("lds", 14, 1), ("lds", 28, 1), ("lds", 14, 4), ("lds", 7, 4),
    ("sel", 14, 1), ("sel", 14, 4), ("prmt", 14, 1), ("prmt", 14, 4),
    ("mix", 14, 1), ("mix", 28, 1),
    ("skel1", 14, 1), ("pair1", 7, 1), ("pair4", 7, 1),
    ("vadd4", 14, 1), ("vadd4", 14, 4), ("vsel", 14, 1), ("vsel", 14, 4),
    ("gather", 14, 1), ("gather", 14, 4),
]
_OPS = ["fadd", "shfl", "smem", "lds", "sel", "prmt", "mix", "skel1", "pair1", "pair4",
        "vadd4", "vsel", "gather"]
_FLOAT_OPS = {"fadd", "lds", "sel", "mix", "skel1", "pair1", "pair4"}

#: Family C: the TPU probe each chain answers, with the Pallas call it
#: replaces.
CHAIN_PROBES = {
    "P1": ("experiments/f32_floor_r4.py:67", [5, 6, 9, 10]),
    "P3": ("experiments/f32_probe.py:185", [3, 4]),
    "P11": ("experiments/op_cost_probe.py:64", [0, 1, 2, 5, 6, 11, 12]),
    "P12": ("experiments/op_cost_probe2.py:64", [7, 8, 13, 14, 19, 20]),
    "P13": ("experiments/pairsum_probe.py:159", [21, 22, 23]),
    "P20": ("experiments/perf_variants6.py:139", [26, 24, 28, 15, 17]),
    "P22": ("experiments/perf_variants7.py:139", [17, 18, 29, 25, 27, 16]),
}

#: Family C's buffer: the TPU probes' [8, 65536] blocks x 9 (an E. coli-
#: sized 4,718,592 elements).
CHAIN_ELEMS = 8 * 65536 * 9


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _library():
    from ..ops import build

    return build.library()


# -- family A -------------------------------------------------------------


def accepts(variant: int, discrete: bool, m: int, k: int) -> bool:
    """Whether instantiation ``variant`` takes an ``m x k`` table in this
    mode (``accepts`` in ``csrc/score.cu``)."""
    lookup, kc = VARIANTS[variant][0], VARIANTS[variant][8]
    if kc and kc != k:
        return False
    if lookup == "shfl":
        return k <= 32
    if lookup == "sel":
        return k <= 8
    if lookup == "prmt":
        return discrete and k <= 7 and m <= 257
    return True


def heads_for(seq: torch.Tensor, m: int, k: int, tp: int) -> torch.Tensor:
    """The side input of a ``"heads"`` instantiation: uint8 ``[blocks,
    head_w]``, row ``b`` the ``m - 1`` bytes after block ``b`` of ``tp``
    positions (the wildcard past the end), ``head_w`` = ``m - 1`` rounded
    up to 16."""
    lp = seq.shape[0]
    blocks = -(-lp // tp)
    head_w = max(16, -(-(m - 1) // 16) * 16)
    padded = torch.full((blocks * tp + head_w,), k - 1, dtype=torch.uint8, device=seq.device)
    padded[:lp] = seq
    idx = (torch.arange(1, blocks + 1, device=seq.device)[:, None] * tp
           + torch.arange(head_w, device=seq.device)[None, :])
    return padded[idx].contiguous()


def _check_variant(variant: int, seq, table, n_scores: int) -> bool:
    if not 0 <= variant < len(VARIANTS):
        raise ValueError(f"variant must be in [0, {len(VARIANTS)}), got {variant}")
    discrete = table.dtype == torch.uint8
    kernels._check(seq, table, torch.uint8 if discrete else torch.float32, n_scores)
    m, k = table.shape
    if not accepts(variant, discrete, m, k):
        raise ValueError(f"variant {variant} {VARIANTS[variant]} does not take a "
                         f"{'u8' if discrete else 'f32'} {m}x{k} table")
    return discrete


def score_variant(variant: int, seq: torch.Tensor, table: torch.Tensor, n_scores: int,
                  heads: torch.Tensor | None = None) -> torch.Tensor:
    """K1 (``table`` float32) or K2 (``table`` uint8) through instantiation
    ``variant`` of the scoring kernel; the inputs and the result are
    those of :func:`..ops.kernels.score_f32` / ``score_u8``.  ``heads``:
    the side input of a ``"heads"`` instantiation (:func:`heads_for`),
    built here when it is not given."""
    discrete = _check_variant(variant, seq, table, n_scores)
    if seq.device.type == "cpu":
        return (torch_ops.score_u8 if discrete else torch_ops.score_f32)(seq, table, n_scores)
    if not (seq.is_contiguous() and table.is_contiguous()):
        raise ValueError("seq and table must be contiguous")
    lib = _library()
    info = [lib.lm_score_variant_info(variant, f) for f in range(10)]
    lookup, p, nt, tp, halo, lazy, persist, minb, kc, grp = VARIANTS[variant]
    if info != [_LOOKUPS.index(lookup), p, nt, tp, _HALOS.index(halo), lazy, persist, minb,
                kc, grp]:
        raise RuntimeError("csrc/score.cu and VARIANTS disagree")
    m, k = table.shape
    smem = lib.lm_score_smem(variant, m, k)
    if not 0 < smem <= kernels._MAX_SMEM:
        raise ValueError(f"variant {variant}: {smem} bytes of shared memory for {m}x{k}")
    lp = seq.shape[0]
    out = torch.empty(lp, dtype=torch.int32 if discrete else torch.float32, device=seq.device)
    if lp == 0:
        return out
    head_ptr, head_w = None, 0
    if halo == "heads":
        if heads is None:
            heads = heads_for(seq, m, k, tp)
        if heads.dtype != torch.uint8 or heads.dim() != 2 or heads.shape[1] < m - 1 \
                or heads.shape[0] < -(-lp // tp) or not heads.is_contiguous():
            raise ValueError(f"heads must be contiguous uint8 [{-(-lp // tp)}, >= {m - 1}]")
        head_ptr, head_w = heads.data_ptr(), heads.shape[1]
    with torch.cuda.device(seq.device):
        err = lib.lm_score_variant(variant, int(discrete), seq.data_ptr(), lp, head_ptr, head_w,
                                   table.data_ptr(), m, k, n_scores, out.data_ptr(), _stream(seq))
    if err != 0:
        raise RuntimeError(f"score_variant {variant} launch failed: CUDA error {err}")
    LAUNCHES["score_variant"] += 1
    return out


# -- family B -------------------------------------------------------------


def diag_plain(mode: str, seq: torch.Tensor, table: torch.Tensor, n_scores: int) -> torch.Tensor:
    """The diagnostic body ``mode`` (:data:`DIAG_MODES`): float32 ``[Lp]``
    (uint8 for ``"u8out"``), written as the JAX body's formula over the
    kernel's ranks (clamped to the wildcard ``K - 1``, which is also read
    past the end); f32 adds in ascending j, products rounded first."""
    m, k = table.shape
    lp = seq.shape[0]
    if mode == "io":
        return seq.to(torch.float32) + table[0, 0]
    s = torch_ops._window_ranks(seq, m, k)
    pos = torch.arange(lp, device=seq.device)
    if mode == "u8out":
        acc = torch.clamp(torch_ops.score_u8(seq, table, lp), max=255)
        return torch.where(pos < n_scores, acc, 255).to(torch.uint8)
    f = s.to(torch.float32)
    if mode == "floor":
        acc = f[:lp] * table[0, 0]
        for j in range(1, m):
            acc = acc + f[j:j + lp] * table[j, 0]
    elif mode == "nosel":
        acc = f[:lp]
        for j in range(1, m):
            acc = acc + f[j:j + lp]
    elif mode == "noroll":
        acc = table[0][s[:lp]]
        for j in range(1, m):
            acc = acc + table[j][s[:lp]]
    elif mode == "add":
        acc = f[:lp]
        for _ in range(1, m):
            acc = acc + f[:lp]
    else:
        raise ValueError(f"mode must be one of {DIAG_MODES}, got {mode!r}")
    return torch.where(pos < n_scores, acc, float("-inf"))


def score_diag(mode: str, seq: torch.Tensor, table: torch.Tensor, n_scores: int) -> torch.Tensor:
    """Family B on the card: diagnostic body ``mode`` of the scoring
    kernel; ``table`` float32 ``[m, K]`` (uint8 for ``"u8out"``)."""
    if mode not in DIAG_MODES:
        raise ValueError(f"mode must be one of {DIAG_MODES}, got {mode!r}")
    discrete = mode == "u8out"
    kernels._check(seq, table, torch.uint8 if discrete else torch.float32, n_scores)
    if seq.device.type == "cpu":
        return diag_plain(mode, seq, table, n_scores)
    if not (seq.is_contiguous() and table.is_contiguous()):
        raise ValueError("seq and table must be contiguous")
    lib = _library()
    if lib.lm_probe_diag_modes() != len(DIAG_MODES):
        raise RuntimeError("csrc/probes.cu and DIAG_MODES disagree")
    m, k = table.shape
    if lib.lm_probe_diag_smem(m, k) > kernels._MAX_SMEM:
        raise ValueError(f"diag: a {m}x{k} table does not fit in shared memory")
    lp = seq.shape[0]
    out = torch.empty(lp, dtype=torch.uint8 if discrete else torch.float32, device=seq.device)
    if lp == 0:
        return out
    with torch.cuda.device(seq.device):
        err = lib.lm_probe_score_diag(DIAG_MODES.index(mode), seq.data_ptr(), lp,
                                      table.data_ptr(), m, k, n_scores, out.data_ptr(),
                                      _stream(seq))
    if err != 0:
        raise RuntimeError(f"probe_score_diag {mode} launch failed: CUDA error {err}")
    LAUNCHES["probe_score_diag"] += 1
    return out


# -- family C -------------------------------------------------------------


def chain_table(op: str, device="cpu") -> torch.Tensor:
    """The table an op chain reads: 32 floats ``(c & 7) + (c >> 3)`` for
    the f32 lookups (the TPU probes' sublane index for ``c < 8``, P13's
    pair4 value for a pair code), the 8 bytes ``3s`` for ``"prmt"`` (the
    TPU probe P22's ``arange * 3``), the 256 bytes ``(7b + 3) % 256`` for
    ``"gather"``; unread by the others."""
    if op == "prmt":
        return torch.tensor([3 * s for s in range(8)], dtype=torch.uint8, device=device)
    if op == "gather":
        return torch.tensor([(7 * b + 3) % 256 for b in range(256)], dtype=torch.uint8,
                            device=device)
    return torch.tensor([(c & 7) + (c >> 3) for c in range(32)], dtype=torch.float32,
                        device=device)


def _roll32(v: torch.Tensor, d: int) -> torch.Tensor:
    """Element e takes the value of lane (e % 32 + d) % 32 of its warp."""
    return torch.roll(v.reshape(-1, 32), -d, dims=1).reshape(-1)


def chain_plain(variant: int, x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """Chain ``variant`` (:data:`CHAINS`) of every element of ``x`` (uint8,
    a multiple of 32 long), as ``csrc/probes.cu`` states it: float32 for
    the f32 ops (the chains folded by left adds in ascending order), int32
    for the others (their sum)."""
    op, steps, chains = CHAINS[variant]
    xi = x.to(torch.int64)
    xf = x.to(torch.float32)
    outs = []
    for c in range(chains):
        xc = xi + c
        if op == "fadd":
            b = xf
            v = xf + float(c)
            for i in range(steps):
                v = v - b if i & 1 else v + b
        elif op in ("shfl", "smem"):
            v = xc
            for i in range(steps):
                v = _roll32(v, 1 + i % 3)
        elif op in ("lds", "sel", "prmt"):
            t = table.to(torch.int64) if op == "prmt" else table
            idx = xc & 7
            v = torch.zeros_like(xi) if op == "prmt" else torch.zeros_like(xf)
            for _ in range(steps):
                v = v + t[idx]
                idx = (idx + 1) & 7
        elif op == "mix":
            idx = xc & 7
            v = table[idx]
            for i in range(steps):
                v = v + _roll32(table[(idx + i) & 7], i + 1)
        elif op in ("skel1", "pair1", "pair4"):
            idx = xc % 5 if op == "skel1" else (xc % 5) * 5 + (xc >> 2) % 5
            v = torch.zeros_like(xf)
            for _ in range(steps):
                idx = _roll32(idx, 1 if op == "skel1" else 2)
                v = v + table[idx & 7 if op == "skel1" else idx]
        elif op in ("vadd4", "vsel", "gather"):
            v = xc & 255
            t = table.to(torch.int64)
            for i in range(steps):
                if op == "vadd4":
                    v = torch.clamp(v + 1 + i % 3, max=255)
                elif op == "vsel":
                    v = torch.where(v >= 200, 7, v + 1)
                else:
                    v = t[v]
        else:
            raise ValueError(f"unknown op {op!r}")
        outs.append(v)
    out = outs[0]
    for v in outs[1:]:
        out = out + v
    return out.to(torch.float32 if op in _FLOAT_OPS else torch.int32)


def op_chain(variant: int, x: torch.Tensor, table: torch.Tensor | None = None) -> torch.Tensor:
    """Family C on the card: chain ``variant`` over ``x`` (uint8 ``[n]``,
    ``n`` a multiple of 32); ``table``: :func:`chain_table` of its op
    (made here when not given)."""
    if not 0 <= variant < len(CHAINS):
        raise ValueError(f"variant must be in [0, {len(CHAINS)}), got {variant}")
    if x.dtype != torch.uint8 or x.dim() != 1 or x.shape[0] % 32:
        raise TypeError(f"x must be uint8 [32 n], got {x.dtype} {tuple(x.shape)}")
    op, steps, chains = CHAINS[variant]
    if table is None:
        table = chain_table(op, x.device)
    want = chain_table(op, "meta")
    if table.dtype != want.dtype or table.shape != want.shape or not table.is_contiguous():
        raise TypeError(f"the {op} chain reads a contiguous {want.dtype} "
                        f"{tuple(want.shape)} table, got {table.dtype} {tuple(table.shape)}")
    if _device_kind(x, table) == "cpu":
        return chain_plain(variant, x, table)
    lib = _library()
    info = [lib.lm_probe_chain_info(variant, f) for f in range(4)]
    if info != [_OPS.index(op), steps, chains, int(op in _FLOAT_OPS)]:
        raise RuntimeError("csrc/probes.cu and CHAINS disagree")
    out = torch.empty(x.shape[0], dtype=torch.float32 if op in _FLOAT_OPS else torch.int32,
                      device=x.device)
    if x.shape[0] == 0:
        return out
    with torch.cuda.device(x.device):
        err = lib.lm_probe_op_chain(variant, x.data_ptr(), x.shape[0], table.data_ptr(),
                                    out.data_ptr(), _stream(x))
    if err != 0:
        raise RuntimeError(f"probe_op_chain {variant} launch failed: CUDA error {err}")
    LAUNCHES["probe_op_chain"] += 1
    return out


# -- P13's host half ------------------------------------------------------


def pair_parity(pssm: np.ndarray, seq: np.ndarray) -> dict:
    """How many windows of ``seq`` (ranks) a pair table would change: the
    exact-bit mismatches between the sequential ascending-j f32 sum of
    ``pssm`` (float32 ``[m, K]``) and the pairwise one ``((t0 + t1) +
    (t2 + t3)) + ...`` (each pair's f32 sum a table entry), and those of
    the prefix-chunk forms (the first r rows summed sequentially into one
    entry, r = 2, 4, 6), which keep the association and must have none.
    Returns ``{"windows", "pairwise", "prefix": {r: mismatches}}``."""
    pmat = np.asarray(pssm, np.float32)
    s = np.asarray(seq).astype(np.intp)
    m = pmat.shape[0]
    n = s.shape[0] - m + 1

    def term(j):
        return pmat[j][s[j:j + n]]

    seq_acc = term(0)
    for j in range(1, m):
        seq_acc = seq_acc + term(j)
    pair_acc = term(0) if m == 1 else None
    for j in range(0, m - 1, 2):
        t = term(j) + term(j + 1)  # the pair table's exact entry
        pair_acc = t if pair_acc is None else pair_acc + t
    if m > 1 and m % 2:
        pair_acc = pair_acc + term(m - 1)
    bits = seq_acc.view(np.int32)
    prefix = {}
    for r in (2, 4, 6):
        pre = term(0)  # the table's entry: the first rows' sequential sum
        for j in range(1, min(r, m)):
            pre = pre + term(j)
        acc = pre
        for j in range(min(r, m), m):
            acc = acc + term(j)
        prefix[r] = int(np.count_nonzero(bits != acc.view(np.int32)))
    return {"windows": int(n), "pairwise": int(np.count_nonzero(bits != pair_acc.view(np.int32))),
            "prefix": prefix}


# -- measurement (the card only) ------------------------------------------


def run_variants(seq: torch.Tensor, w: torch.Tensor, dm: torch.Tensor, n_scores: int,
                 repeat: int = 20, runs: int = 5) -> list:
    """Family A on the card: every instantiation, in each mode it takes,
    equal to the plain version, and its device time per launch (``heads``
    built before the timing)."""
    out = []
    for table in (w, dm):
        discrete = table.dtype == torch.uint8
        plain = (torch_ops.score_u8 if discrete else torch_ops.score_f32)(seq, table, n_scores)
        m, k = table.shape
        for v, row in enumerate(VARIANTS):
            if not accepts(v, discrete, m, k):
                continue
            heads = heads_for(seq, m, k, row[3]) if row[4] == "heads" else None
            got = score_variant(v, seq, table, n_scores, heads)
            torch.cuda.synchronize()
            _equal(got, plain, f"score variant {v} {row} {'u8' if discrete else 'f32'}")
            ms = time_cuda(lambda: score_variant(v, seq, table, n_scores, heads),
                           repeat=repeat, runs=runs)
            out.append({"family": "A", "variant": v, "mode": "u8" if discrete else "f32",
                        "lookup": row[0], "positions_per_thread": row[1], "threads": row[2],
                        "positions_per_block": row[3], "halo": row[4], "lazy": row[5],
                        "persistent": row[6], "blocks_per_sm": row[7], "k_fixed": row[8],
                        "group": row[9],
                        "equal": True,
                        "ms": ms,
                        "production": v == _library().lm_score_production(int(discrete)),
                        "probes": [p for p, (_, vs) in PROBE_VARIANTS.items() if v in vs]})
    return out


def run_diag(seq: torch.Tensor, w: torch.Tensor, dm: torch.Tensor, n_scores: int,
             repeat: int = 20, runs: int = 5) -> list:
    """Family B on the card: each body equal to its plain version, its
    time and its plain version's."""
    out = []
    for mode in DIAG_MODES:
        table = dm if mode == "u8out" else w
        want = diag_plain(mode, seq, table, n_scores)
        got = score_diag(mode, seq, table, n_scores)
        torch.cuda.synchronize()
        _equal(got, want, f"diag {mode}")
        ms = time_cuda(lambda: score_diag(mode, seq, table, n_scores), repeat=repeat, runs=runs)
        plain_ms = time_cuda(lambda: diag_plain(mode, seq, table, n_scores), runs=3)
        probe, rep = DIAG_PROBES[mode]
        out.append({"family": "B", "mode": mode, "probe": probe, "replaces": rep,
                    "equal": True, "ms": ms, "plain_ms": plain_ms})
    return out


def run_chains(x: torch.Tensor, repeat: int = 20, runs: int = 5) -> list:
    """Family C on the card: each chain equal to its plain version, its
    time, its plain version's, and its op rate (steps x chains x elements
    over the time)."""
    out = []
    for v, (op, steps, chains) in enumerate(CHAINS):
        table = chain_table(op, x.device)
        want = chain_plain(v, x, table)
        got = op_chain(v, x, table)
        torch.cuda.synchronize()
        _equal(got, want, f"chain {v} {CHAINS[v]}")
        ms = time_cuda(lambda: op_chain(v, x, table), repeat=repeat, runs=runs)
        plain_ms = time_cuda(lambda: chain_plain(v, x, table), runs=3)
        out.append({"family": "C", "variant": v, "op": op, "steps": steps, "chains": chains,
                    "equal": True, "ms": ms, "plain_ms": plain_ms,
                    "gops_s": steps * chains * x.shape[0] / ms / 1e6,
                    "probes": [p for p, (_, vs) in CHAIN_PROBES.items() if v in vs]})
    return out


@functools.cache
def genome(device) -> tuple:
    """``bench.py``'s inputs: the 4,641,652 bp genome (seed 0xECC011) as
    ranks on ``device``, PRODORIC MX000001's f32 PSSM and its discrete
    table, and the window count."""
    from .. import CountMatrix, EncodedSequence

    cm = CountMatrix.from_sequences(
        EncodedSequence.encode(p) for p in ["GTTGACCTTATCAAC", "GTTGATCCAGTCAAC"])
    pssm = cm.to_freq(0.1).to_weight(None).to_scoring()
    rng = np.random.default_rng(0xECC011)
    g = rng.integers(0, 4, size=4_641_652, dtype=np.int8).astype(np.uint8)
    seq = torch.from_numpy(g).to(device)
    w = torch.from_numpy(np.asarray(pssm.data, np.float32)).to(device)
    dm = torch.from_numpy(pssm.to_discrete().data).to(device)
    return seq, w, dm, g.size - len(pssm) + 1, pssm


def chain_input(device) -> torch.Tensor:
    """Family C's buffer: :data:`CHAIN_ELEMS` seeded random bytes."""
    rng = np.random.default_rng(0xC4A1)
    return torch.from_numpy(rng.integers(0, 256, CHAIN_ELEMS).astype(np.uint8)).to(device)


def main() -> int:
    if not torch.cuda.is_available():
        print("probes: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    seq, w, dm, n, pssm = genome(device)
    for row in run_variants(seq, w, dm, n) + run_diag(seq, w, dm, n):
        print(json.dumps(row), flush=True)
    for row in run_chains(chain_input(device)):
        print(json.dumps(row), flush=True)
    print(json.dumps({"probe": "P13", "host": "pair_parity",
                      **pair_parity(pssm.data, seq.cpu().numpy())}), flush=True)
    print(json.dumps({"launches": LAUNCHES}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
