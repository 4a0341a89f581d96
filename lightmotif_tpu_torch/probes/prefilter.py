"""Probes of the multi-motif prefilter on an NVIDIA Hopper card.

    python -m lightmotif_tpu_torch.probes.prefilter

Counterparts of the JAX package's Pallas probes of its prefilter, each a
kernel in ``ops/csrc/`` with a plain version, checked with
``torch.equal`` and timed with CUDA events:

* **P6** (``experiments/int8_probe.py:54``): the tensor cores' int8 and
  bf16 rates at the prefilter's operand shapes, ``max over 2,048 lanes
  of filt[l] . x[p]`` over the JAX probe's three contraction blocks of
  128 (signed int8 cells, 0/1 windows), on ``wgmma`` fed by TMA
  (``csrc/probe_gmma.cu``), each as a share of the card's int8 or bf16
  peak; one block is the earlier ``mma.sync`` probe's depth.  Plain
  version: an f32 matmul of the same small integers, which is exact.
* **P7** (``experiments/int8_probe2.py:98``): the tensor-core prefilter
  against the lookup kernel it replaced (``lookup_kernel`` in
  ``csrc/prefilter.cu``), parity and time, at a database group's shape.
* **P8** (``experiments/multi_opt.py:106``) and **P10**
  (``experiments/multi_opt2.py:95``): the instantiations of the
  tensor-core kernel (:data:`VARIANTS`) in each orientation -- positions
  as the product's rows (P8) or as its columns (P10, the transposed
  windows) -- over lane chunks per pass and positions per block, at the
  shape of ``bench.py``'s u8 (K4) row.  The best point is the one the
  kernel's entry points launch (``PRODUCTION`` in ``csrc/prefilter.cu``).
* **P9** (``experiments/multi_opt.py:193``, ``prefilter_bits2``): per-lane
  pass bits, ``(score >= t) & (p < n_valid)``, 16 lanes per int32 word,
  from the production instantiation with another epilogue
  (``lm_prefilter_bits``), timed against K3 on the same group, so that
  what per-lane bits cost beside the running max is known.  Plain
  version: :func:`prefilter_bits_plain`.

None of these runs on a path of the package; :data:`LAUNCHES` counts
their launches apart from :data:`..ops.multi_kernel.LAUNCHES`.  Every
wrapper runs its plain version for tensors on the CPU and its kernel
for CUDA tensors, and raises on anything else.  Run as a module, it
builds seeded inputs, runs every probe once on the current card and
prints one JSON object per probe.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys

import numpy as np
import torch

from ..ops import multi, multi_kernel, torch_ops

__all__ = [
    "LAUNCHES",
    "VARIANTS",
    "reset_launches",
    "mma_inputs",
    "mma_operands",
    "mma_max",
    "mma_max_plain",
    "lookup_table",
    "prefilter_lookup",
    "prefilter_variant",
    "prefilter_bits",
    "prefilter_bits_plain",
    "time_cuda",
    "run_p6",
    "run_p7",
    "run_sweep",
    "run_p9",
]

#: Kernel launches of each probe wrapper since :func:`reset_launches`.
LAUNCHES = {"probe_mma_int8": 0, "probe_mma_bf16": 0, "prefilter_lookup": 0,
            "prefilter_variant": 0, "prefilter_bits": 0}

#: The tensor-core kernel's instantiations, in the order of ``LM_VARIANTS``
#: in ``csrc/prefilter.cu``: (orientation, lane chunks per pass, positions
#: per warp, warps per block).  Orientation ``"m"``: positions are the
#: product's M rows; ``"n"``: its N columns.
VARIANTS = [("m", 1, 32, 8), ("m", 1, 64, 8), ("m", 1, 128, 8), ("m", 1, 64, 16),
            ("m", 2, 64, 8), ("n", 1, 32, 8), ("n", 1, 64, 8), ("n", 1, 128, 8),
            ("n", 1, 64, 16), ("n", 2, 64, 8)]

#: P6's operand shapes, the JAX probe's: filters of 2,048 lanes (``M``),
#: contraction blocks of 128, ``BLOCKS = 3`` of them, 1,024-position tiles.
P6_LANES = 2048
P6_BLOCK = 128
P6_BLOCKS = 3
P6_TILE = 1024

#: P6's forms and their operands' dtype.
P6_DTYPES = {"int8": torch.int8, "bf16": torch.bfloat16}

# the card's published peaks (NVIDIA H100 SXM data sheet, dense, 700 W)
PEAK_OPS_PER_S = {"int8": 1979e12, "bf16": 989e12}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _device_kind(*tensors) -> str:
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devices))}")
    kind = devices.pop().type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {kind}")
    return kind


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


# -- P6 -----------------------------------------------------------------------


def mma_inputs(n_pos: int, seed: int = 0, blocks: int = P6_BLOCKS):
    """P6's operands, numpy, drawn as ``experiments/int8_probe.py`` draws
    them (``main``, with its tile of ``n_pos`` positions and ``blocks``
    blocks of 128): ``filt`` int8 ``[2048, 128 * blocks]`` from
    ``integers(-100, 100)`` and ``x`` int8 ``[n_pos, 128 * blocks]`` from
    {0, 1}, K-major: the transposes of the JAX probe's ``[depth, M]`` and
    ``[depth, tile]``."""
    rng = np.random.default_rng(seed)
    depth = P6_BLOCK * blocks
    fb = rng.integers(-100, 100, (depth, P6_LANES))
    xb = rng.integers(0, 2, (depth, n_pos))
    return (np.ascontiguousarray(fb.T.astype(np.int8)),
            np.ascontiguousarray(xb.T.astype(np.int8)))


def mma_operands(filt: torch.Tensor, x: torch.Tensor, kind: str):
    """``filt`` and ``x`` (int8) in the dtype of P6's form ``kind``: int8
    as they are, or the same integers as bf16 (exact)."""
    if kind not in P6_DTYPES:
        raise ValueError(f"kind must be one of {tuple(P6_DTYPES)}, got {kind!r}")
    return filt.to(P6_DTYPES[kind]), x.to(P6_DTYPES[kind])


def mma_max_plain(filt: torch.Tensor, x: torch.Tensor, block: int = 1 << 16) -> torch.Tensor:
    """``max_l sum_d filt[l, d] * x[p, d]`` as int32 ``[n_pos]``: an f32
    matmul (TF32 off) of the int8 or bf16 cells, exact because every sum
    is an integer of magnitude below ``2**24``."""
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        f = filt.float()
        out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
        for p0 in range(0, x.shape[0], block):
            part = x[p0:p0 + block].float() @ f.T  # [n, lanes]
            out[p0:p0 + block] = part.amax(dim=1).to(torch.int32)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    return out


def mma_max(filt: torch.Tensor, x: torch.Tensor, kind: str = "int8") -> torch.Tensor:
    """P6: ``max_l sum_d filt[l, d] * x[p, d]`` as int32 ``[n_pos]`` on the
    tensor cores' ``wgmma`` (``csrc/probe_gmma.cu``), s8 x s8 -> s32
    (``kind="int8"``) or bf16 x bf16 -> f32 (``"bf16"``, its max converted
    to int32).  ``filt``: ``[lanes, 128 * blocks]`` and ``x``: ``[n_pos,
    128 * blocks]``, both int8 or both bf16 as ``kind`` says (see
    :func:`mma_operands`), ``blocks`` 3 (the JAX probe's depth) or 1 (the
    earlier ``mma.sync`` probe's).  The plain version takes any number of
    lanes; the kernel takes P6's 2,048 and raises on others."""
    from ..ops import build

    if kind not in P6_DTYPES:
        raise ValueError(f"kind must be one of {tuple(P6_DTYPES)}, got {kind!r}")
    dtype = P6_DTYPES[kind]
    depth = filt.shape[1] if filt.dim() == 2 else -1
    if (filt.dtype != dtype or filt.dim() != 2 or filt.shape[0] < 1 or depth % P6_BLOCK
            or depth // P6_BLOCK not in (1, P6_BLOCKS)):
        raise TypeError(f"filt must be {dtype} [lanes, 128 * blocks] with 1 or "
                        f"{P6_BLOCKS} blocks, got {filt.dtype} {tuple(filt.shape)}")
    if x.dtype != dtype or x.dim() != 2 or x.shape[1] != depth:
        raise TypeError(f"x must be {dtype} [n, {depth}], got {x.dtype} {tuple(x.shape)}")
    if _device_kind(filt, x) == "cpu":
        return mma_max_plain(filt, x)
    if filt.shape[0] != P6_LANES:
        raise ValueError(f"the P6 kernel takes {P6_LANES} lanes, got {filt.shape[0]}")
    if not (filt.is_contiguous() and x.is_contiguous()) or (filt.data_ptr() | x.data_ptr()) % 16:
        raise ValueError("mma_max takes contiguous tensors on 16-byte boundaries")
    lib = build.probe_library()
    if [lib.lm_probe_gmma_shape(f) for f in range(3)] != [P6_LANES, P6_BLOCK, P6_BLOCKS]:
        raise RuntimeError("csrc/probe_gmma.cu and the P6 shapes disagree")
    out = torch.empty(x.shape[0], dtype=torch.int32, device=x.device)
    if x.shape[0] == 0:
        return out
    with torch.cuda.device(x.device):
        err = lib.lm_probe_gmma(int(kind == "bf16"), filt.data_ptr(), x.data_ptr(), x.shape[0],
                                depth // P6_BLOCK, out.data_ptr(), _stream(x))
    if err != 0:
        raise RuntimeError(f"probe_mma_{kind} launch failed: error {err}")
    LAUNCHES[f"probe_mma_{kind}"] += 1
    return out


# -- P7 -----------------------------------------------------------------------


def lookup_table(planes: torch.Tensor) -> torch.Tensor:
    """The lookup kernel's int32 table ``[chunks, rows, K, 16]`` (``table[c,
    j, s, l]`` = the cell of lane ``16c + l``) of a prefilter's planes."""
    n_planes, chunks, lanes, rows, k = planes.shape
    cells = torch_ops.plane_cells(planes).reshape(chunks, lanes, rows, k)
    return cells.permute(0, 2, 3, 1).contiguous()


def prefilter_lookup(seq: torch.Tensor, table: torch.Tensor, chunk_m: torch.Tensor,
                     t_eff: torch.Tensor) -> torch.Tensor:
    """P7's baseline: the prefilter as the lookup kernel computes it, one
    int32 per (position, lane, row) from shared memory.  ``table``: the
    int32 ``[chunks, rows, K, 16]`` of :func:`lookup_table`."""
    from ..ops import build

    if table.dtype != torch.int32 or table.dim() != 4 or table.shape[3] != multi_kernel.K3_LANES:
        raise TypeError(f"table must be int32 [chunks, rows, K, {multi_kernel.K3_LANES}], "
                        f"got {table.dtype} {tuple(table.shape)}")
    chunks, rows, k, lanes = table.shape
    if seq.dtype != torch.uint8 or seq.dim() != 1:
        raise TypeError(f"seq must be a 1-D uint8 tensor, got {seq.dtype}")
    if tuple(chunk_m.shape) != (chunks,) or tuple(t_eff.shape) != (chunks * lanes,):
        raise TypeError("chunk_m and t_eff do not match the table")
    if _device_kind(seq, table, chunk_m, t_eff) == "cpu":
        planes = table.permute(0, 3, 1, 2).to(torch.int64)
        cells = torch.stack([(planes >> (8 * q)) & 255 for q in range(4)]).to(torch.uint8)
        return torch_ops.prefilter_any8(seq, cells, chunk_m, t_eff)
    lib = build.probe_library()
    smem = lib.lm_prefilter_lookup_smem(rows, k)
    if smem > multi_kernel._MAX_SMEM:
        raise ValueError(f"lookup kernel: {smem} bytes of shared memory for {rows} rows")
    out = torch.empty(seq.shape[0], dtype=torch.int32, device=seq.device)
    with torch.cuda.device(seq.device):
        err = lib.lm_prefilter_lookup(seq.data_ptr(), seq.shape[0], table.data_ptr(),
                                      chunk_m.data_ptr(), t_eff.data_ptr(), chunks,
                                      rows, k, out.data_ptr(), _stream(seq))
    if err != 0:
        raise RuntimeError(f"prefilter_lookup launch failed: CUDA error {err}")
    LAUNCHES["prefilter_lookup"] += 1
    return out


# -- P8 and P10 ---------------------------------------------------------------


def prefilter_variant(variant: int, seq: torch.Tensor, planes: torch.Tensor,
                      chunk_m: torch.Tensor, t_eff: torch.Tensor) -> torch.Tensor:
    """The prefilter through instantiation ``variant`` (an index of
    :data:`VARIANTS`) of the tensor-core kernel; the inputs are those of
    :func:`..ops.multi_kernel.prefilter_any8`."""
    from ..ops import build

    if not 0 <= variant < len(VARIANTS):
        raise ValueError(f"variant must be in [0, {len(VARIANTS)}), got {variant}")
    multi_kernel._check("prefilter_variant", seq, planes, chunk_m, t_eff)
    if seq.device.type == "cpu":
        return torch_ops.prefilter_any8(seq, planes, chunk_m, t_eff)
    lib = build.probe_library()
    orient, cpp, pw, warps = VARIANTS[variant]
    if lib.lm_prefilter_variant_info(variant) != (warps << 24 | (orient == "m") << 16
                                                  | cpp << 8 | pw):
        raise RuntimeError("csrc/prefilter.cu and VARIANTS disagree")
    out = multi_kernel.launch("prefilter_variant", variant, seq, planes, chunk_m, t_eff,
                              lib=lib)
    LAUNCHES["prefilter_variant"] += 1
    return out


# -- P9 -----------------------------------------------------------------------


def prefilter_bits_plain(seq: torch.Tensor, planes: torch.Tensor, chunk_m: torch.Tensor,
                         t_eff: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """P9's plain version: int32 ``[Lp, chunks]``, bit ``l`` of word ``c``
    set where lane ``16c + l``'s window sum reaches its threshold
    (``sum - t_eff >= 0``) at a position below its ``n_valid``.  The
    cells are :func:`..ops.torch_ops.plane_cells` of the planes, as in
    :func:`..ops.torch_ops.prefilter_any8`."""
    cells = torch_ops.plane_cells(planes)
    lanes, m, k = cells.shape
    d = cells.permute(1, 2, 0).contiguous()  # d[j, s, lane]
    lp = seq.shape[0]
    s = torch_ops._window_ranks(seq, m, k)
    weights = (1 << torch.arange(multi_kernel.K3_LANES, device=seq.device)).repeat(
        lanes // multi_kernel.K3_LANES)
    out = torch.empty((lp, lanes // multi_kernel.K3_LANES), dtype=torch.int32,
                      device=seq.device)
    blk = max(1, torch_ops._K3_BLOCK_ELEMS // lanes)
    for p0 in range(0, lp, blk):
        p1 = min(p0 + blk, lp)
        acc = d[0][s[p0:p1]]
        for j in range(1, m):
            acc += d[j][s[p0 + j:p1 + j]]
        pos = torch.arange(p0, p1, device=seq.device)[:, None]
        bit = (acc - t_eff >= 0) & (pos < n_valid)
        out[p0:p1] = (bit.to(torch.int64) * weights).reshape(p1 - p0, -1, 16).sum(2).to(
            torch.int32)
    return out


def prefilter_bits(seq: torch.Tensor, planes: torch.Tensor, chunk_m: torch.Tensor,
                   t_eff: torch.Tensor, n_valid: torch.Tensor) -> torch.Tensor:
    """P9: the per-lane pass bits of :func:`prefilter_bits_plain` from the
    production tensor-core instantiation with the bits epilogue; the
    inputs are those of :func:`..ops.multi_kernel.prefilter_any8` and
    ``n_valid``, int32 ``[lanes]``."""
    from ..ops import build

    multi_kernel._check("prefilter_bits", seq, planes, chunk_m, t_eff)
    if n_valid.dtype != torch.int32 or tuple(n_valid.shape) != tuple(t_eff.shape):
        raise TypeError(f"n_valid must be int32 {tuple(t_eff.shape)}, got "
                        f"{n_valid.dtype} {tuple(n_valid.shape)}")
    if _device_kind(seq, n_valid) == "cpu":
        return prefilter_bits_plain(seq, planes, chunk_m, t_eff, n_valid)
    if not n_valid.is_contiguous():
        raise ValueError("n_valid must be contiguous")
    lib = build.probe_library()
    n_planes, chunks, _, rows, k = planes.shape
    smem = lib.lm_prefilter_smem(lib.lm_prefilter_production(), rows, k, n_planes)
    if not 0 < smem <= multi_kernel._MAX_SMEM:
        raise ValueError(f"prefilter_bits: {smem} bytes of shared memory")
    lp = seq.shape[0]
    out = torch.empty((lp, chunks), dtype=torch.int32, device=seq.device)
    if lp == 0:
        return out
    with torch.cuda.device(seq.device):
        err = lib.lm_prefilter_bits(seq.data_ptr(), lp, planes.data_ptr(), n_planes, chunks,
                                    rows, k, chunk_m.data_ptr(), t_eff.data_ptr(),
                                    n_valid.data_ptr(), out.data_ptr(), _stream(seq))
    if err != 0:
        raise RuntimeError(f"prefilter_bits launch failed: CUDA error {err}")
    LAUNCHES["prefilter_bits"] += 1
    return out


def production_variant() -> int:
    """The index of ``mma_kernel``'s instantiation that the entry points
    launch for the shapes the warpgroup kernel does not take, and that P9
    shares."""
    from ..ops import build

    return build.probe_library().lm_prefilter_production()


# -- measurement (the card only) ----------------------------------------------


def time_cuda(fn, repeat: int = 1, runs: int = 15) -> float:
    """Median milliseconds of one ``fn()`` over ``runs`` samples after a
    warm-up, timed with CUDA events around ``repeat`` calls queued
    behind a GPU spin (so the events time the device work)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # about 25 ms at 2 GHz
        start.record()
        for _ in range(repeat):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / repeat)
    return statistics.median(times)


def _equal(got, want, what: str) -> None:
    if not torch.equal(got, want):
        bad = int(torch.nonzero(got != want)[0])
        raise AssertionError(f"{what}: kernel != plain at {bad}: "
                             f"{got[bad].item()} vs {want[bad].item()}")


def _p6_library(f: torch.Tensor, x: torch.Tensor, kind: str, want: torch.Tensor):
    """The library yardstick of P6's form ``kind``: one PyTorch product of
    the same operands with exact sums, then ``amax`` -- int8
    ``torch._int_mm`` (cuBLASLt, s32 sums), bf16 ``torch.mm(...,
    out_dtype=torch.float32)`` (f32 sums) -- in blocks of 65,536 positions.
    Returns ``(ms, what)``, or ``(None, why)`` where this torch has no such
    call or its result is not P6's."""
    block = 1 << 16
    if kind == "int8":
        what = "torch._int_mm + amax"

        def product(xb):
            return torch._int_mm(xb, f.T)
    else:
        what = "torch.mm(out_dtype=torch.float32) + amax"

        def product(xb):
            return torch.mm(xb, f.T, out_dtype=torch.float32)

    def library():
        return torch.cat([product(x[p0:p0 + block]).amax(dim=1)
                          for p0 in range(0, x.shape[0], block)]).to(torch.int32)

    try:
        got = library()
        torch.cuda.synchronize()
        _equal(got, want, f"P6 library ({what})")
    except (RuntimeError, TypeError, AttributeError, AssertionError) as e:
        return None, f"{what}: {type(e).__name__}: {str(e).splitlines()[0][:120]}"
    return time_cuda(library, runs=3), what


def run_p6(filt: torch.Tensor, x: torch.Tensor) -> list:
    """P6 on the card at the depth of its int8 operands (``filt``
    ``[2048, 128 * blocks]``, ``x`` ``[n_pos, 128 * blocks]``, as
    :func:`mma_inputs` draws them), one row per form: equal to the plain
    version; its time, rate and share of the form's peak; ``l2_tb_per_s``,
    the rate that asks of L2 (every tile of 128 positions streams all of
    ``filt``); its bound (operations over the peak, or each operand read
    once and the output written once over 3.35 TB/s), the plain version's
    time and the library yardstick (:func:`_p6_library`).  The bf16
    operands are made before any timing."""
    n_pos, depth = x.shape
    ops = 2.0 * filt.shape[0] * depth * n_pos
    tiles = -(-n_pos // 128)
    want = mma_max_plain(filt, x)
    plain_ms = time_cuda(lambda: mma_max_plain(filt, x), runs=3)
    out = []
    for kind in P6_DTYPES:
        f, xk = mma_operands(filt, x, kind)
        nbytes = (f.numel() + xk.numel()) * f.element_size() + 4 * n_pos
        got = mma_max(f, xk, kind)
        torch.cuda.synchronize()
        _equal(got, want, f"P6 {kind}")
        ms = time_cuda(lambda: mma_max(f, xk, kind), repeat=5)
        library_ms, library = _p6_library(f, xk, kind, want)
        peak = PEAK_OPS_PER_S[kind]
        out.append({"probe": "P6", "name": f"probe_mma_{kind}", "equal": True,
                    "positions": n_pos, "blocks": depth // P6_BLOCK,
                    "ms": ms, "tops": ops / ms / 1e9,
                    "share_of_peak": ops / (ms * 1e-3) / peak,
                    "l2_tb_per_s": f.numel() * f.element_size() * tiles / (ms * 1e-3) / 1e12,
                    "bound_ms": max(ops / peak, nbytes / 3.35e12) * 1e3,
                    "bound_by": "operations" if ops / peak >= nbytes / 3.35e12 else "bytes",
                    "plain_ms": plain_ms, "library_ms": library_ms, "library": library})
    return out


def run_p7(seq: torch.Tensor, planes: torch.Tensor, chunk_m: torch.Tensor,
           t_eff: torch.Tensor) -> dict:
    """P7 on the card: the tensor-core kernel (production instantiation)
    and the lookup kernel, each equal to the plain version, timed in
    turns (lookup, new, new, lookup)."""
    table = lookup_table(planes)
    v = production_variant()
    want = torch_ops.prefilter_any8(seq, planes, chunk_m, t_eff)
    new = prefilter_variant(v, seq, planes, chunk_m, t_eff)
    old = prefilter_lookup(seq, table, chunk_m, t_eff)
    torch.cuda.synchronize()
    _equal(new, want, "P7 tensor-core kernel")
    _equal(old, want, "P7 lookup kernel")
    o1 = time_cuda(lambda: prefilter_lookup(seq, table, chunk_m, t_eff), repeat=3)
    n1 = time_cuda(lambda: prefilter_variant(v, seq, planes, chunk_m, t_eff), repeat=3)
    n2 = time_cuda(lambda: prefilter_variant(v, seq, planes, chunk_m, t_eff), repeat=3)
    o2 = time_cuda(lambda: prefilter_lookup(seq, table, chunk_m, t_eff), repeat=3)
    return {"probe": "P7", "name": "prefilter_lookup", "equal": True,
            "positions": seq.shape[0], "lanes": t_eff.shape[0], "planes": planes.shape[0],
            "rows_needed": int(chunk_m.sum()), "lookup_ms": min(o1, o2),
            "tensor_core_ms": min(n1, n2), "speedup": min(o1, o2) / min(n1, n2),
            "runs": [o1, n1, n2, o2]}


def run_sweep(seq: torch.Tensor, planes: torch.Tensor, chunk_m: torch.Tensor,
              t_eff: torch.Tensor, orientation: str) -> list:
    """P8 (``orientation="m"``) or P10 (``"n"``): every instantiation of
    that orientation equal to the plain version, and its time."""
    want = torch_ops.prefilter_any8(seq, planes, chunk_m, t_eff)
    out = []
    for v, (orient, cpp, pw, warps) in enumerate(VARIANTS):
        if orient != orientation:
            continue
        got = prefilter_variant(v, seq, planes, chunk_m, t_eff)
        torch.cuda.synchronize()
        _equal(got, want, f"variant {v} {VARIANTS[v]}")
        ms = time_cuda(lambda: prefilter_variant(v, seq, planes, chunk_m, t_eff), repeat=3)
        out.append({"probe": "P8" if orientation == "m" else "P10", "variant": v,
                    "orientation": orient, "chunks_per_pass": cpp,
                    "warps": warps, "positions_per_block": warps * pw,
                    "equal": True, "ms": ms,
                    "production": v == production_variant()})
    return out


def run_p9(seq: torch.Tensor, planes: torch.Tensor, chunk_m: torch.Tensor,
           t_eff: torch.Tensor, n_valid: torch.Tensor) -> dict:
    """P9 on the card: the bits equal to the plain version, and their time
    beside the running max of the instantiation they share (``mma_kernel``'s
    production one) on the same inputs, in turns (max, bits, bits, max)."""
    want = prefilter_bits_plain(seq, planes, chunk_m, t_eff, n_valid)
    got = prefilter_bits(seq, planes, chunk_m, t_eff, n_valid)
    torch.cuda.synchronize()
    _equal(got.reshape(-1), want.reshape(-1), "P9 bits")
    from ..ops import build

    mma = lambda: multi_kernel.launch(  # noqa: E731
        "prefilter_any8", production_variant(), seq, planes, chunk_m, t_eff,
        lib=build.probe_library())
    bits = lambda: prefilter_bits(seq, planes, chunk_m, t_eff, n_valid)  # noqa: E731
    a1 = time_cuda(mma, repeat=3)
    b1 = time_cuda(bits, repeat=3)
    b2 = time_cuda(bits, repeat=3)
    a2 = time_cuda(mma, repeat=3)
    plain_ms = time_cuda(lambda: prefilter_bits_plain(seq, planes, chunk_m, t_eff, n_valid),
                         runs=3)
    return {"probe": "P9", "name": "prefilter_bits", "equal": True,
            "positions": seq.shape[0], "lanes": t_eff.shape[0],
            "words_nonzero": int((got != 0).sum()), "bits_ms": min(b1, b2),
            "mma_kernel_ms": min(a1, a2),
            "plain_ms": plain_ms, "runs": [a1, b1, b2, a2]}


def _genome_planes(device):
    """Seeded stand-ins: the 4,641,652 bp genome of ``bench.py`` (seed
    0xECC011), a 2,048-lane u16 group of DNA motifs of 5-16 rows (a
    database group's shape) and ``bench.py``'s u8 row: 1,024 lanes of m =
    15, cells 0-199, thresholds 2,400 written by hand (seed 11)."""
    rng = np.random.default_rng(0xECC011)
    genome = rng.integers(0, 4, size=4_641_652, dtype=np.int8).astype(np.uint8)
    seq = torch.from_numpy(genome).to(device)
    rng = np.random.default_rng(0x9A0)
    lengths = np.sort(rng.integers(5, 17, 2048))
    d16 = np.zeros((2048, 16, 5), np.uint32)
    t16 = np.zeros(2048, np.int64)
    for i, m in enumerate(lengths):
        # rows scaled as fine_discretize scales them: a lane's best window
        # sums to about 65,534; thresholds in its top fifth
        top = 65534 // m
        d16[i, :m] = rng.integers(0, top + 1, size=(m, 5))
        d16[i, :m, rng.integers(0, 4)] = 0
        t16[i] = int(rng.uniform(0.8, 0.95) * m * top)
    group = multi.pack_filters_k3(d16, t16)
    rng = np.random.default_rng(11)
    dms = rng.integers(0, 200, size=(1024, 15, 5)).astype(np.float32)
    dms[:, :, 4] = 0.0
    filters_t = multi_kernel.pack_filters_any(dms, np.full(1024, 2400), 5)
    filters_t[multi_kernel._lanes_for(5) - 1, :] = -2400.0
    bench = multi.pack_filters_k4(filters_t, 5)
    dev = lambda arrays: [torch.from_numpy(a).to(device) for a in arrays]  # noqa: E731
    return seq, dev(group), dev(bench)


def main() -> int:
    if not torch.cuda.is_available():
        print("probes: no CUDA device", file=sys.stderr)
        return 1
    device = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"card": card, "torch": torch.__version__}), flush=True)
    for blocks in (P6_BLOCKS, 1):
        filt, x = (torch.from_numpy(a).to(device)
                   for a in mma_inputs(P6_TILE * 256, blocks=blocks))
        for row in run_p6(filt, x):
            print(json.dumps(row), flush=True)
    seq, group, bench = _genome_planes(device)
    print(json.dumps(run_p7(seq, *group)), flush=True)
    for orientation in ("m", "n"):
        for row in run_sweep(seq, *bench, orientation):
            print(json.dumps(row), flush=True)
    print(json.dumps({"launches": LAUNCHES}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
